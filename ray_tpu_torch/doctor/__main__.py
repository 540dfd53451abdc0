"""``python -m ray_tpu_torch.doctor`` — see :mod:`ray_tpu_torch.doctor`."""

import sys

from ray_tpu_torch.doctor import main

if __name__ == "__main__":
    sys.exit(main())
