"""Tensors to and from numpy on the host, with bf16 kept bit for bit.

numpy has no bfloat16. The JAX package's ``np.asarray`` of a bf16 array
gives ``ml_dtypes.bfloat16`` values, so a bf16 tensor crosses to numpy as
its bits viewed as that dtype: the predictor returns it, the collective
CPU group reduces it, and the checkpoint engine hashes and writes it, the
same bytes and dtype as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host: a view of a CPU tensor's
    storage, a copy of a CUDA tensor's. bf16 comes back as
    ``ml_dtypes.bfloat16`` where ``ml_dtypes`` imports, and as float32
    otherwise (the same values, exactly)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def from_numpy(arr, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A new tensor of ``dtype`` (default: ``arr``'s) on ``device`` holding
    ``arr``'s values: never a view of ``arr``, so callers may each own
    theirs."""
    arr = np.array(arr, copy=True, order="C")    # the caller's own copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)
