"""Block-wise quantization for the collective compression tier.

EQuARX-style dynamic block quantization (arxiv 2506.17615): a tensor is
cut into contiguous blocks of ``quant_block_bytes`` input bytes; each
block ships a one-byte-per-element payload plus one f32 absmax-derived
scale. Two schemes:

- ``q8``  — symmetric int8, scale = absmax/127, round-to-nearest.
  Per-element error is bounded by scale/2 = absmax/254 of the block.
- ``fp8`` — ``ml_dtypes.float8_e4m3fn``, scale = absmax/448 (the e4m3
  finite max), so the block's dynamic range maps onto the fp8 exponent
  range. Cheaper relative error near zero, coarser near absmax.

Dequantization is fused into the reduction (`accumulate`): payloads are
widened to f32 and summed at full precision — quantized ranks never
accumulate in int8, so the only error is the one round-trip per rank.

The q8 path has a native kernel (``_native/quant.cc``, built on first
use with vectorization flags) ~3x faster than the fused numpy fallback;
payloads agree to the last bit of rounding (scales within one f32 ULP,
both round-to-nearest-even), so ranks may mix the two.

Wire accounting: ``Quantized.wire_bytes`` = payload + scales bytes —
what actually crosses a link — distinct from the logical tensor bytes
the comms ledger also records. At the default 256-byte block an f32
tensor ships at ~0.27x (64 payload bytes + 4 scale bytes per 256
logical bytes).

Non-finite blocks quantize to a poisoned ``scale = -1`` (payload
zeroed); dequantization rejects them loudly instead of shipping silent
garbage — matching the native kernel bit-for-bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

SCHEMES = ("none", "q8", "fp8")

_FP8_MAX = 448.0  # float8_e4m3fn finite max

_native_lib = None
_native_tried = False


def _native():
    """The quant kernel library, built on first use (None = numpy only)."""
    global _native_lib, _native_tried
    if not _native_tried:
        from ray_tpu_torch._native.build import QUANT_OPT_FLAGS, load_native_library
        _native_lib = load_native_library("quant", opt_flags=QUANT_OPT_FLAGS)
        _native_tried = True
    return _native_lib


def _fp8_dtype():
    import ml_dtypes
    return np.dtype(ml_dtypes.float8_e4m3fn)


@dataclass(frozen=True)
class Quantized:
    """One rank's compressed collective payload."""

    scheme: str            # "q8" | "fp8"
    payload: np.ndarray    # int8 (q8) or float8_e4m3fn (fp8), flat
    scales: np.ndarray     # f32, one per block (-1 poisons a non-finite block)
    shape: tuple           # original tensor shape
    dtype: Any             # original tensor dtype (np.dtype)
    block: int             # elements per block

    @property
    def nbytes(self) -> int:
        """Logical bytes of the tensor this payload represents (the comms
        ledger's ``bytes`` column; ``wire_bytes`` is what moved)."""
        return int(np.prod(self.shape, dtype=np.int64)) * \
            np.dtype(self.dtype).itemsize

    @property
    def wire_bytes(self) -> int:
        return int(self.payload.nbytes + self.scales.nbytes)


@dataclass(frozen=True)
class QuantFault:
    """Deposited at the rendezvous in place of a payload when a rank's
    quantization step raised (e.g. a chaos ``collective.quant`` fault).
    The compute raises the carried error into the shared outcome, so
    every rank fails loudly instead of the peers timing out waiting for
    the faulted rank's payload."""

    error: BaseException
    shape: tuple
    dtype: Any


def block_elems(block_bytes: int, dtype) -> int:
    """Elements per block: ``quant_block_bytes`` counts *input* bytes, so
    the scale overhead per block is fixed regardless of input width."""
    return max(1, int(block_bytes) // max(1, np.dtype(dtype).itemsize))


def quantizable(arr) -> bool:
    """Only real float tensors compress; ints/bools/complex pass through
    at full precision (their collectives are typically tiny control
    values where bit-exactness matters more than bytes)."""
    return np.dtype(arr.dtype).kind == "f"


def active(config, arr) -> bool:
    return (config is not None
            and getattr(config, "compression", "none") != "none"
            and quantizable(arr))


# -- q8 -----------------------------------------------------------------------


def _q8_quantize_native(flat: np.ndarray, be: int, lib):
    import ctypes
    n = flat.size
    nb = -(-n // be)
    q = np.empty(n, np.int8)
    scales = np.empty(nb, np.float32)
    lib.rtq_q8_quantize(
        ctypes.c_void_p(flat.ctypes.data), ctypes.c_int64(n),
        ctypes.c_int64(be), ctypes.c_void_p(q.ctypes.data),
        ctypes.c_void_p(scales.ctypes.data))
    return q, scales


def _blocked(flat: np.ndarray, be: int) -> np.ndarray:
    """(nb, be) view of ``flat`` zero-padded to a whole number of blocks."""
    n = flat.size
    nb = -(-n // be)
    if nb * be == n:
        return flat.reshape(nb, be)
    padded = np.zeros(nb * be, flat.dtype)
    padded[:n] = flat
    return padded.reshape(nb, be)

def _np_quantize(flat: np.ndarray, be: int, scheme: str):
    blocks = _blocked(flat, be)
    absmax = np.max(np.abs(blocks), axis=1)
    bad = ~np.isfinite(absmax)
    if scheme == "q8":
        scales = (absmax / 127.0).astype(np.float32)
        safe = np.where(scales > 0.0, scales, 1.0)
        q = np.clip(np.rint(blocks / safe[:, None]), -127, 127) \
            .astype(np.int8)
    else:
        scales = (absmax / _FP8_MAX).astype(np.float32)
        safe = np.where(scales > 0.0, scales, 1.0)
        # clip: e4m3fn has no inf, so values a hair over the finite max
        # (scale rounding) must saturate, not wrap to nan
        q = np.clip(blocks / safe[:, None], -_FP8_MAX,
                    _FP8_MAX).astype(_fp8_dtype())
    if bad.any():
        q[bad] = 0
        scales[bad] = -1.0
    return q.reshape(-1)[:flat.size], scales


def quantize(tensor, config, *, group: str = "default", op: str = "",
             rank: int = -1) -> Quantized:
    """Compress one rank's tensor per its group config.

    This is the ``collective.quant`` chaos seam: a fault schedule can
    error/delay exactly one rank's quantization step (labels: group, op,
    rank) — the deterministic drill for "a quantized op fails loudly and
    retries clean". Quantize time lands in the ``collective.quantize``
    perf histogram so compression cost is visible next to op latency.
    """
    from ray_tpu_torch import chaos
    from ray_tpu_torch.observability import perf
    if chaos.ENABLED:
        chaos.inject("collective.quant", group=group, op=op, rank=str(rank))
    t0 = time.monotonic() if perf.ENABLED else 0.0
    scheme = config.compression
    if scheme not in ("q8", "fp8"):
        raise ValueError(f"unknown compression scheme {scheme!r}; "
                         f"use one of {SCHEMES}")
    arr = np.asarray(tensor)
    be = block_elems(config.quant_block_bytes, arr.dtype)
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    lib = _native() if scheme == "q8" else None
    if lib is not None:
        q, scales = _q8_quantize_native(flat, be, lib)
    else:
        q, scales = _np_quantize(flat, be, scheme)
    out = Quantized(scheme=scheme, payload=q, scales=scales,
                    shape=tuple(arr.shape), dtype=np.dtype(arr.dtype),
                    block=be)
    if perf.ENABLED:
        perf.observe("collective.quantize", (time.monotonic() - t0) * 1e3)
    return out


def _check_scales(q: Quantized) -> None:
    if q.scales.size and float(q.scales.min()) < 0.0:
        raise ValueError(
            f"{q.scheme} payload carries poisoned block scale(s): the "
            f"source tensor had non-finite values; refusing to dequantize")


def _dequant_f32(q: Quantized) -> np.ndarray:
    """Flat f32 dequantization (the widen half of the fused reduce)."""
    _check_scales(q)
    n = int(np.prod(q.shape, dtype=np.int64))
    lib = _native() if q.scheme == "q8" else None
    if lib is not None:
        import ctypes
        out = np.empty(n, np.float32)
        lib.rtq_q8_dequant(
            ctypes.c_void_p(q.payload.ctypes.data), ctypes.c_void_p(
                q.scales.ctypes.data), ctypes.c_int64(n),
            ctypes.c_int64(q.block), ctypes.c_void_p(out.ctypes.data))
        return out
    blocks = _blocked(q.payload.astype(np.float32), q.block)
    return (blocks * q.scales[:, None]).reshape(-1)[:n]


def dequantize(q: Quantized) -> np.ndarray:
    """Round-trip back to the original shape and dtype."""
    return _dequant_f32(q).reshape(q.shape).astype(q.dtype, copy=False)


def accumulate(q: Quantized, acc: np.ndarray) -> None:
    """``acc += dequant(q)`` fused at f32 — the reduction never sums in
    int8. ``acc`` is a flat f32 array of the tensor's element count."""
    _check_scales(q)
    lib = _native() if q.scheme == "q8" else None
    if lib is not None:
        import ctypes
        lib.rtq_q8_dequant_add(
            ctypes.c_void_p(q.payload.ctypes.data),
            ctypes.c_void_p(q.scales.ctypes.data),
            ctypes.c_int64(acc.size), ctypes.c_int64(q.block),
            ctypes.c_void_p(acc.ctypes.data))
        return
    acc += _dequant_f32(q)


def reduce_quantized(items, reduce_np=None) -> np.ndarray:
    """Reduce a list of same-shape :class:`Quantized` payloads at full
    precision. SUM takes the fused accumulate path; other reductions
    (``reduce_np`` from the backend's numpy table) widen each payload
    first. Returns the reduced tensor in the original shape/dtype."""
    first = items[0]
    if reduce_np is None:  # SUM
        acc = _dequant_f32(first).copy()
        for q in items[1:]:
            accumulate(q, acc)
        return acc.reshape(first.shape).astype(first.dtype, copy=False)
    widened = np.stack([_dequant_f32(q).reshape(q.shape) for q in items])
    return reduce_np(widened).astype(first.dtype, copy=False)


def hierarchical_allreduce(xs, config, reduce_np=None, *,
                           group: str = "default", op_name: str = "allreduce"):
    """Two-level allreduce over rank-ordered tensors ``xs``.

    Contiguous spans of ``ranks_per_host`` ranks form a "host". The
    intra-host reduction runs at full precision (that hop is the
    in-process path, where bytes are cheap), then ONLY the per-host
    partials cross the inter-host seam quantized — the reduce-scatter/
    allreduce/allgather decomposition collapsed to its byte-accounting
    essence for in-process groups, where both hops are function calls
    but the wire ledger must still tell them apart.

    Returns ``(reduced, wire_per_rank)``: ``wire_per_rank`` is each
    rank's share of the quantized inter-host traffic (total quantized
    partial bytes / world), which is what makes hierarchical groups
    report *less* wire than flat quantized ones — the point of the
    decomposition.
    """
    world = len(xs)
    rph = config.ranks_per_host
    if rph <= 1 or world % rph or world == rph:
        raise ValueError(
            f"hierarchical allreduce needs 1 < ranks_per_host < world and "
            f"ranks_per_host | world; got ranks_per_host={rph} world={world}")
    hosts = world // rph
    partials = []
    for h in range(hosts):
        span = np.stack([np.asarray(xs[r])
                         for r in range(h * rph, (h + 1) * rph)])
        partials.append(np.sum(span, axis=0) if reduce_np is None
                        else reduce_np(span))
    qs = [quantize(p, config, group=group, op=op_name, rank=h * rph)
          for h, p in enumerate(partials)]
    red = reduce_quantized(qs, reduce_np)
    wire = sum(q.wire_bytes for q in qs) // world
    return red, wire


def qmeta(config, arr) -> tuple:
    """The (scheme, block_elems) pair folded into collective fingerprints:
    mixed-scheme ranks must raise CollectiveDivergenceError, not corrupt
    the reduction with a half-quantized accumulate."""
    if not active(config, arr):
        return ("none", 0)
    return (config.compression,
            block_elems(config.quant_block_bytes, arr.dtype))
