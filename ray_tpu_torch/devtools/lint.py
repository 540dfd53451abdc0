"""CLI entry point: ``python -m ray_tpu_torch.devtools.lint [roots...]``.

Thin shim over :mod:`ray_tpu_torch.devtools.linter` so the module path reads as
a command.  Exit status 0 = clean, 1 = findings, 2 = usage error.
"""

import sys

from ray_tpu_torch.devtools.linter import main

if __name__ == "__main__":
    sys.exit(main())
