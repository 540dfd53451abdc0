"""The numbers that decide ``correct``, and their limits.

Training, over the first steps that set-up drives through the window's own
call (the reference follows the same steps from the same seed):
- ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over those steps;
- ``grad_gap``: the first gradient as the optimizer got it, by the worst
  leaf: the gap between the program's norm of the leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``change_gap``: the same for the norm of each leaf's change over the
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).

Serving, over a sample of the answers:
- ``logit_err``: the largest relative L2 distance of a served row of
  logits from the reference's;
- ``missing``: requests due in the window that never got an answer (limit 0).

A limit comes from the workload file (``check``), set from readings of
sound runs and of the control; a run is correct when every number is at or
under its limit.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Sequence, Tuple

import torch

SMALL_GRAD = 1e-3


def _leaf_gap(prog: Sequence[float], ref: Sequence[float],
              keep: Sequence[bool]) -> float:
    floor = statistics.median(ref)
    return max(abs(p - r) / max(r, floor, 1e-30)
               for p, r, k in zip(prog, ref, keep) if k)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"loss": [...], "grad_norms": [...],
    "change_norms": [...]}``, the norms a leaf in ``leaf_specs`` order."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["loss"], ref["loss"]))
    g = ref["grad_norms"]
    everyone = [True] * len(g)
    moved = [x >= SMALL_GRAD * statistics.median(g) for x in g]
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad_norms"], g, everyone),
            "change_gap": _leaf_gap(prog["change_norms"],
                                    ref["change_norms"], moved)}


def serve_numbers(served: Sequence[torch.Tensor],
                  ref: Sequence[torch.Tensor], missing: int
                  ) -> Dict[str, float]:
    errs = [float((s.double() - r.double()).norm() / r.double().norm())
            for s, r in zip(served, ref)]
    return {"logit_err": max(errs) if errs else float("inf"),
            "missing": float(missing)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def print_checks(checks: Dict[str, dict]) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.detach().float()))
            for t in tensors]
