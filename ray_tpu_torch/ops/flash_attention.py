"""Flash attention: CUDA kernels for Hopper, forward and backward, and their
plain versions.

Port of ``ray_tpu/ops/flash_attention.py``. Each Pallas TPU kernel becomes a
hand-written CUDA C++ kernel (each source's header says what bounds it on an
H100 and how it is laid out):
- ``_fwd_kernel`` -> ``csrc/flash_attention_fwd.cu``; plain version
  ``flash_attention_reference``;
- ``_dq_kernel`` and ``_dkv_kernel`` -> ``csrc/flash_attention_bwd.cu``;
  plain version ``flash_attention_bwd_reference``.

The dtype alone picks the kernel. bf16 inputs run the forward, dq and dkv
on the tensor cores (``wgmma``, with P and dS rounded to bf16 before their
dots); f32 inputs run every product as an f32 FMA.

``_FlashAttention`` is the ``torch.autograd.Function`` that the JAX
package's ``jax.custom_vjp`` becomes: its forward saves (q, k, v, O, LSE),
its backward returns (dq, dk, dv). Delta = rowsum(dO * O) is a torch op
outside the kernels, as JAX computes it outside Pallas.

Routing is by the device of the inputs and nothing else:
- a CUDA tensor launches the kernels, or raises (unsupported dtype, head
  dim, layout or alignment);
- only a CPU tensor takes the plain versions, through the same Function.

``launches``, ``dq_launches`` and ``dkv_launches`` count kernel launches,
so a run can show that its attention went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

# Kernel launches since the process started (or since a caller reset it).
launches = 0        # forward kernel
dq_launches = 0     # dq kernel
dkv_launches = 0    # dkv kernel
_count_lock = threading.Lock()

# C entry point -> (kernel source in csrc/, tensor pointers, int64 strides).
# Every entry point takes, after its pointers: device, B, H, Lq, Lk, D,
# dtype, causal (ints), scale (float); then three strides per tensor and
# the stream.
_ENTRY_POINTS = {
    "ray_tpu_torch_flash_attention_fwd": ("flash_attention_fwd", 5, 12),
    "ray_tpu_torch_flash_attention_dq": ("flash_attention_bwd", 7, 15),
    "ray_tpu_torch_flash_attention_dkv": ("flash_attention_bwd", 8, 18),
}
_entries = {}  # bound C entry points, set at first launch


def _kernel_entry(symbol: str):
    fn = _entries.get(symbol)
    if fn is None:
        from ray_tpu_torch.ops import _build
        source, n_ptr, n_strides = _ENTRY_POINTS[symbol]
        fn = getattr(_build.load(source), symbol)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([p] * n_ptr + [i] * 8 + [ctypes.c_float]
                       + [i64] * n_strides + [p])
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def _run_kernel(symbol: str, tensors, q: torch.Tensor, k: torch.Tensor,
                causal: bool, scale: float) -> None:
    """Launch ``symbol`` on q's stream; ``tensors`` are its pointer
    arguments in order, the [B, L, H, D] ones passing their strides too."""
    B, Lq, H, D = q.shape
    strides = [st for t in tensors if t.dim() == 4 for st in t.stride()[:3]]
    err = _kernel_entry(symbol)(
        *(t.data_ptr() for t in tensors), q.device.index, B, H, Lq,
        k.shape[1], D, KERNEL_DTYPES[q.dtype], int(causal), float(scale),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seqlen, heads, head_dim]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Lq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Raise on what the CUDA kernels do not take.

    The bf16 kernels copy 16-byte chunks into shared memory (the forward
    with TMA, dq and dkv with ``cp.async``), so each bf16 tensor must start
    on a 16-byte boundary and its batch, sequence and head strides must be
    multiples of 16 bytes (8 elements). The f32 kernels read element by
    element and take any layout that is contiguous in head_dim."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash-attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim, "
                             f"strides {t.stride()}")
        if t.dtype == torch.bfloat16 and not _aligned_16(t):
            raise ValueError(
                f"bf16 {name} must start on a 16-byte boundary with batch, "
                f"sequence and head strides that are multiples of 8 "
                f"elements; got address {t.data_ptr()} and strides "
                f"{t.stride()}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("batch * heads must be at most 65535 (grid limit)")


def _aligned_16(t: torch.Tensor) -> bool:
    """Base address, and the stride of every dim but the last that has
    more than one index, at 16 bytes."""
    elt = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * elt % 16 == 0
                    for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check_kernel_inputs(q, k, v)
    B, Lq, H, D = q.shape
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _run_kernel("ray_tpu_torch_flash_attention_fwd", (q, k, v, out, lse),
                q, k, causal, scale)
    with _count_lock:
        launches += 1
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, causal: bool,
               scale: float) -> torch.Tensor:
    """dq kernel: dQ [B, Lq, H, D] in q's dtype. Inputs as ``_launch_bwd``
    hands them over (checked, dO contiguous in D, LSE and Delta f32
    contiguous [B, H, Lq])."""
    global dq_launches
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _run_kernel("ray_tpu_torch_flash_attention_dq",
                (q, k, v, do, lse, delta, dq), q, k, causal, scale)
    with _count_lock:
        dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool,
                scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dkv kernel: dK and dV [B, Lk, H, D] in k's dtype. Inputs as for
    ``_launch_dq``."""
    global dkv_launches
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _run_kernel("ray_tpu_torch_flash_attention_dkv",
                (q, k, v, do, lse, delta, dk, dv), q, k, causal, scale)
    with _count_lock:
        dkv_launches += 1
    return dk, dv


def _launch_bwd(q, k, v, out, lse, do, causal: bool, scale: float):
    _check_kernel_inputs(q, k, v)
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _aligned_16(do)):
        # The gradient autograd hands back may be strided in D (e.g. after
        # a transpose downstream) or off the 16-byte grid the bf16 kernel's
        # copies need; the kernels read D contiguously.
        do = do.contiguous()
    delta = attention_delta(out, do)
    lse = lse.contiguous()
    dq = _launch_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense PyTorch version of the kernel: ``(O, LSE)``.

    Same masking as the kernel: top-left causal (``row >= col``), masked
    scores at -1e30 with exactly zero probability, l clamped at 1e-30.
    Computes in float32; O comes back in the input dtype, LSE as float32
    ``[B, H, Lq]``.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    Lq, Lk = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)            # [B,H,Lq,1]
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, vf)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in float32, as ``[B, H, Lq]`` contiguous.

    O is the forward's output in its own dtype (bf16 O is rounded before
    Delta is formed, as in the JAX package, which saves O in bf16)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Dense PyTorch version of the two backward kernels: ``(dq, dk, dv)``.

    Follows their formulas, not autograd: P = exp(S - LSE) under the same
    top-left causal mask, Delta = ``attention_delta(out, do)``,
    dS = P * (dP - Delta) * scale with dP = dO V^T, then dQ = dS K,
    dK = dS^T Q, dV = P^T dO. Computes in float32; each gradient comes back
    in its input's dtype.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    Lq, Lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_delta(out, do)[..., None]) * scale
    if causal:
        mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        p = torch.where(mask, p, 0.0)
        ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_device(q: torch.Tensor) -> None:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, LSE)`` for q/k/v ``[B, L, H, D]``; LSE is float32 ``[B, H, Lq]``.

    CUDA tensors go to the kernel; CPU tensors to the plain version.
    """
    _check_shapes(q, k, v)
    _check_device(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    return flash_attention_reference(q, k, v, causal, scale)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's residuals and dO = dL/dO.

    ``out`` and ``lse`` are what ``flash_attention_fwd`` returned. CUDA
    tensors go to the dq and dkv kernels; CPU tensors to the plain version.
    """
    _check_shapes(q, k, v)
    _check_device(q)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    B, Lq, H, _ = q.shape
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Lq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out and dO must be {q.dtype}, got {out.dtype} "
                         f"and {do.dtype}")
    if not (q.device == out.device == lse.device == do.device):
        raise ValueError("q, out, lse and dO on different devices")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, out, lse, do, causal, scale)
    return flash_attention_bwd_reference(q, k, v, out, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX package's ``jax.custom_vjp`` around
    ``_flash_attention_bhld``: the forward saves (q, k, v, O, LSE) as
    ``_fwd_rule`` does; the backward returns (dq, dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Flash attention. q/k/v: [batch, seqlen, heads, head_dim].

    Returns [batch, seqlen, heads, head_dim]. Differentiable: when a
    gradient is wanted the call goes through ``_FlashAttention``; otherwise
    (``torch.inference_mode()``, ``torch.no_grad()``, or no input that
    requires grad) it runs the forward alone and saves nothing.
    ``block_q``/``block_k`` keep the JAX signature; they are tiling hints
    that change no result. The CUDA kernels fix their own tiles: in the
    forward 64 Q rows by 64 K rows a step for f32 and 128 Q rows by 128 K
    rows for bf16; in dq 64 Q rows by 64 K rows (32 for bf16 at head_dim
    128); in dkv 64 K rows by 64 Q rows (32 for bf16 at head_dim 128).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal, scale)[0]
