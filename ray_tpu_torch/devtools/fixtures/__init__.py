"""Self-check fixture corpus for raylint (``--self-check``).

Each ``rN_*.py`` file carries positive and negative cases for one rule:
the reference's neutral fixtures with their imports spelled
``ray_tpu_torch``, and the PyTorch forms of R5, R21 and R27-R29, line for
line where the JAX form has a counterpart; ``expected.json`` freezes the exact
findings the corpus must round-trip. The directory is excluded from
normal lint walks (see ``LintEngine._iter_files``) and is only analyzed
when rooted here explicitly — these files are never imported at runtime.
"""
