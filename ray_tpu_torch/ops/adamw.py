"""AdamW and each leaf's sum of squared gradients in one pass: a CUDA kernel
for Hopper, and its plain version.

The JAX package has no kernel here: XLA fuses ``optax.adamw`` and
``optax.global_norm`` into the jitted step. The port's eager step would run
``torch.optim.AdamW``'s foreach passes and a separate square-and-sum for the
norm; ``csrc/adamw.cu`` does both in one pass over parameters, gradients and
both moments (its header says what bounds it and how it is laid out).

``adamw_step`` steps a list of f32 leaves in place and returns each leaf's
sum of g*g (the gradient norm's parts):
- CUDA tensors go to the kernel, one launch for up to ``MAX_LEAVES``
  leaves, or raise (a leaf that is not f32 and contiguous, leaves on more
  than one device);
- CPU tensors go to ``adamw_reference``, which repeats the kernel's
  arithmetic with torch ops.

Each leaf's coefficients come from ``coefficients``: torch's AdamW
(foreach, not capturable) computes the same scalars in double from the
leaf's step count.

``adamw_launches`` counts the kernel's launches and ``adamw_elements`` the
elements they stepped, so a run can show that its optimizer went through
the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Sequence

import torch

# Kernel launches and elements stepped since the process started (or since a
# caller reset them).
adamw_launches = 0
adamw_elements = 0
_count_lock = threading.Lock()


class Coefficients(NamedTuple):
    """One leaf's scalars for a step, in the kernel's table order."""
    decay: float      # 1 - lr * weight_decay
    w1: float         # 1 - beta1: lerp's weight for exp_avg
    b2: float         # beta2
    omb2: float       # 1 - beta2
    neg_step: float   # -(lr / (1 - beta1^t))
    bc2_sqrt: float   # sqrt(1 - beta2^t)
    eps: float


def coefficients(step: int, lr: float, beta1: float, beta2: float,
                 eps: float, weight_decay: float) -> Coefficients:
    """The scalars of step ``step`` (from 1), in double as torch computes
    them; the kernel takes them rounded to f32."""
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    return Coefficients(1 - lr * weight_decay, 1 - beta1, beta2, 1 - beta2,
                        (lr / bc1) * -1, bc2 ** 0.5, eps)


def adamw_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    exp_avgs: Sequence[torch.Tensor],
                    exp_avg_sqs: Sequence[torch.Tensor],
                    coefs: Sequence[Coefficients]) -> torch.Tensor:
    """Plain version of the kernel: the same update in place, in torch's
    order (``torch.optim.AdamW``'s foreach passes, one leaf at a time), and
    each leaf's f32 sum of g*g as a 1-d tensor."""
    sums = []
    for p, g, m, v, c in zip(params, grads, exp_avgs, exp_avg_sqs, coefs):
        p.mul_(c.decay)
        m.lerp_(g, c.w1)
        v.mul_(c.b2).addcmul_(g, g, value=c.omb2)
        denom = (v.sqrt() / c.bc2_sqrt).add_(c.eps)
        p.addcdiv_(m, denom, value=c.neg_step)
        sums.append(g.square().sum())
    if not sums:
        return torch.zeros(0, dtype=torch.float32)
    return torch.stack(sums)


# ctypes mirror of csrc/adamw.cu's Leaf and Table.
class _Leaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("numel", ctypes.c_int64), ("chunk_begin", ctypes.c_int),
                ("out", ctypes.c_int), ("vec", ctypes.c_int),
                *((name, ctypes.c_float) for name in Coefficients._fields)]


MAX_LEAVES = 40  # leaves one launch steps; more take further launches


class _Table(ctypes.Structure):
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("n_leaves", ctypes.c_int),
                ("n_chunks", ctypes.c_int), ("chunk_sums", ctypes.c_void_p),
                ("leaf_sums", ctypes.c_void_p)]


_lib = None  # the bound library, set at first launch
_chunk = 0   # elements a chunk, read from the library


def _library():
    global _lib, _chunk
    if _lib is None:
        from ray_tpu_torch.ops import _build
        lib = _build.load("adamw")
        for name in ("ray_tpu_torch_adamw_table_bytes",
                     "ray_tpu_torch_adamw_max_leaves",
                     "ray_tpu_torch_adamw_chunk"):
            getattr(lib, name).restype = ctypes.c_int
        got = (lib.ray_tpu_torch_adamw_table_bytes(),
               lib.ray_tpu_torch_adamw_max_leaves())
        want = (ctypes.sizeof(_Table), MAX_LEAVES)
        if got != want:
            raise RuntimeError(f"csrc/adamw.cu's table (bytes, leaves) {got} "
                               f"does not match the wrapper's {want}")
        lib.ray_tpu_torch_adamw.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
        lib.ray_tpu_torch_adamw.restype = ctypes.c_int
        _chunk = lib.ray_tpu_torch_adamw_chunk()
        _lib = lib
    return _lib


def _check_kernel_leaves(groups) -> torch.device:
    device = groups[0][0].device
    for i, leaf in enumerate(groups):
        shape = leaf[0].shape
        for name, t in zip(("param", "grad", "exp_avg", "exp_avg_sq"), leaf):
            if t.device != device:
                raise ValueError(f"leaf {i}: {name} on {t.device}, the "
                                 f"first param on {device}; the kernel "
                                 f"steps one device's leaves a launch")
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError(f"leaf {i}: the AdamW kernel takes "
                                f"contiguous float32 tensors; {name} is "
                                f"{t.dtype}, strides {t.stride()}")
            if t.shape != shape:
                raise ValueError(f"leaf {i}: {name} shape {tuple(t.shape)} "
                                 f"differs from the param's {tuple(shape)}")
    return device


def _launch(leaves, coefs: Sequence[Coefficients],
            device: torch.device) -> torch.Tensor:
    global adamw_launches, adamw_elements
    lib = _library()
    work = [(i, leaf, c) for i, (leaf, c) in enumerate(zip(leaves, coefs))
            if leaf[0].numel() > 0]
    # An empty leaf's sum is 0; every other slot is written by the kernel.
    sums = (torch.empty if len(work) == len(leaves) else torch.zeros)(
        len(leaves), dtype=torch.float32, device=device)
    batches = [work[i:i + MAX_LEAVES]
               for i in range(0, len(work), MAX_LEAVES)]
    n_chunks = [sum(-(-leaf[0].numel() // _chunk) for _, leaf, _ in batch)
                for batch in batches]
    scratch = torch.empty(max(n_chunks, default=0), dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for batch, chunks in zip(batches, n_chunks):
        table = _Table(n_leaves=len(batch), n_chunks=chunks,
                       chunk_sums=scratch.data_ptr(),
                       leaf_sums=sums.data_ptr())
        begin = 0
        for row, (out, (p, g, m, v), c) in zip(table.leaf, batch):
            ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
            row.p, row.g, row.m, row.v = ptrs
            row.numel, row.chunk_begin, row.out = p.numel(), begin, out
            row.vec = int(all(x % 16 == 0 for x in ptrs))
            (row.decay, row.w1, row.b2, row.omb2, row.neg_step,
             row.bc2_sqrt, row.eps) = c
            begin += -(-p.numel() // _chunk)
        err = lib.ray_tpu_torch_adamw(ctypes.byref(table), device.index,
                                      stream)
        if err != 0:
            raise RuntimeError(f"ray_tpu_torch_adamw launch failed: CUDA "
                               f"error {err}")
        with _count_lock:
            adamw_launches += 1
            adamw_elements += sum(leaf[0].numel() for _, leaf, _ in batch)
    return sums


def adamw_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avgs: Sequence[torch.Tensor],
               exp_avg_sqs: Sequence[torch.Tensor],
               coefs: Sequence[Coefficients]) -> torch.Tensor:
    """Step every leaf in place (params, exp_avgs and exp_avg_sqs) and
    return each leaf's f32 sum of g*g, a 1-d tensor on the leaves' device.

    CUDA leaves go to the kernel; CPU leaves to ``adamw_reference``.
    """
    leaves: List[tuple] = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    coefs = list(coefs)
    if len(leaves) != len(params) or len(coefs) != len(params):
        raise ValueError("params, grads, exp_avgs, exp_avg_sqs and coefs "
                         "must have one entry a leaf")
    if not leaves:
        return torch.zeros(0, dtype=torch.float32)
    if any(t.device.type == "cuda" for leaf in leaves for t in leaf):
        return _launch(leaves, coefs, _check_kernel_leaves(leaves))
    if any(t.device.type != "cpu" for leaf in leaves for t in leaf):
        raise ValueError("the AdamW pass runs on cuda or cpu tensors")
    return adamw_reference(params, grads, exp_avgs, exp_avg_sqs, coefs)
