"""Framed out-of-band serialization (pickle protocol 5).

The reference gets zero-copy numpy out of plasma by pinning arrays in shm
(serialization.py + plasma). Same idea here: large array payloads are
pickled with out-of-band buffers and laid out in a frame —

  MAGIC  u32 idx_len  idx(header_len, nbuf, buf_lens...)  header
  [64-aligned buffer 0] [64-aligned buffer 1] ...

— so the ENCODE side copies each array at most once and the DECODE side
copies nothing: arrays are reconstructed backed by views into the received
frame (a TCP blob, pinned shared-arena pages, or the local store's arena).

Two encoders share the layout:

- ``dumps_framed``: materializes the whole frame into one bytearray (one
  copy per array). Used where a contiguous payload is required.
- ``FramedPayload``: keeps the array bytes IN their source buffers and
  exposes the frame as a gather list, so a fetch/push chunk leaves via
  ``sendmsg`` scatter-gather with zero serialize-side copies.

This module is the single owner of the layout; ``distributed.py`` (wire)
and ``object_store.py`` (arena receive slots) both decode through it.
"""

from __future__ import annotations

import io
import pickle
import struct as _struct
from typing import Any, List, Tuple

import cloudpickle

FRAME_MAGIC = b"RTF5"
_PAD = bytes(64)  # alignment gaps are always < 64 bytes


def frame_layout(header_len: int, buf_lens: List[int], trace: bytes = b""):
    """Frame geometry. ``trace`` is an optional provenance blob appended
    to the index (after the fixed ``header_len, nbuf, buf_lens`` part) —
    decoders detect it as ``idx_len > 8 + 8 * nbuf``. An empty trace keeps
    the frame byte-identical to the pre-trace format, which the checkpoint
    engine's content-addressed dedup relies on."""
    idx = _struct.pack(f">II{len(buf_lens)}Q", header_len, len(buf_lens),
                       *buf_lens) + trace
    header_off = 4 + 4 + len(idx)
    off = (header_off + header_len + 63) & ~63
    buf_offs = []
    for ln in buf_lens:
        buf_offs.append(off)
        off = (off + ln + 63) & ~63
    return off, header_off, buf_offs, idx


def _pickle_oob(value: Any, pickler=None):
    """-> (header_bytes, [byte-cast readonly buffer views]). ``pickler``:
    a ``pickle.Pickler`` class to use in place of cloudpickle."""
    pbufs: List[Any] = []
    if pickler is None:
        header = cloudpickle.dumps(value, protocol=5,
                                   buffer_callback=pbufs.append)
    else:
        out = io.BytesIO()
        pickler(out, protocol=5, buffer_callback=pbufs.append).dump(value)
        header = out.getvalue()
    raws = []
    for b in pbufs:
        try:
            raws.append(b.raw())
        except Exception:  # raylint: allow(swallow) raw() raises for non-contiguous buffers by contract; materialize instead
            raws.append(memoryview(bytes(b)))
    return header, raws


def dumps_framed(value: Any, trace: bytes = b"", pickler=None) -> bytearray:
    """Serialize into one framed payload (single copy per array).
    ``pickler``: as for ``_pickle_oob``."""
    header, raws = _pickle_oob(value, pickler)
    total, hoff, boffs, idx = frame_layout(len(header),
                                           [r.nbytes for r in raws], trace)
    out = bytearray(total)
    out[0:4] = FRAME_MAGIC
    out[4:8] = _struct.pack(">I", len(idx))
    out[8:8 + len(idx)] = idx
    out[hoff:hoff + len(header)] = header
    for off, r in zip(boffs, raws):
        out[off:off + r.nbytes] = r
    # returned as the bytearray itself — bytes(out) would duplicate the
    # whole frame; consumers slice per-chunk
    return out


def loads_framed(view, unpickler=None) -> Tuple[Any, bool]:
    """Decode a frame from ``view`` (bytes or memoryview); ``unpickler``, a
    ``pickle.Unpickler`` class, resolves the globals it names.

    Returns ``(value, zero_copy)``: when ``zero_copy`` the value's arrays
    reference ``view`` directly — the caller must keep the backing alive
    (and pinned, for arena pages) for the value's lifetime."""
    mv = memoryview(view).toreadonly()  # sealed objects are immutable —
    # a writable view into shared arena pages must never leak to users
    if mv[:4] != FRAME_MAGIC:
        # legacy plain-pickle payload
        if unpickler is None:
            return pickle.loads(mv), False
        return unpickler(io.BytesIO(bytes(mv))).load(), False
    (idx_len,) = _struct.unpack(">I", mv[4:8])
    header_len, nbuf = _struct.unpack_from(">II", mv, 8)
    buf_lens = list(_struct.unpack_from(f">{nbuf}Q", mv, 16))
    # Offsets from idx_len directly, so frames with a trailing trace blob
    # in the index (idx_len > 8 + 8*nbuf) decode identically.
    hoff = 8 + idx_len
    off = (hoff + header_len + 63) & ~63
    boffs = []
    for ln in buf_lens:
        boffs.append(off)
        off = (off + ln + 63) & ~63
    header = bytes(mv[hoff:hoff + header_len])
    buffers = [mv[off:off + ln] for off, ln in zip(boffs, buf_lens)]
    if unpickler is None:
        return pickle.loads(header, buffers=buffers), nbuf > 0
    return unpickler(io.BytesIO(header), buffers=buffers).load(), nbuf > 0


def frame_trace(view) -> str:
    """The provenance blob embedded in a frame's index, decoded to str
    (``"trace_id:span_id"``), or ``""`` when absent / not an RTF5 frame.
    Reads only the fixed-size prefix — never decodes the payload."""
    mv = memoryview(view)
    if len(mv) < 16 or bytes(mv[:4]) != FRAME_MAGIC:
        return ""
    (idx_len,) = _struct.unpack(">I", mv[4:8])
    (nbuf,) = _struct.unpack_from(">I", mv, 12)
    base = 8 + 8 * nbuf
    if idx_len <= base:
        return ""
    try:
        return bytes(mv[8 + base:8 + idx_len]).decode("ascii")
    except UnicodeDecodeError:
        return ""


class FramedPayload:
    """A framed serialization whose array bytes never left their source
    buffers. Byte-identical on the wire to ``dumps_framed(value)``, but
    exposed as (offset, view) segments: ``slices(a, b)`` returns the
    gather list for any byte range, ready for ``sendmsg`` scatter-gather.

    Holding a ``FramedPayload`` keeps the source arrays alive (the views
    reference their exporters), which is exactly the serve-cache contract:
    a chunked fetch must see stable bytes even if the object is freed
    from the store mid-transfer.
    """

    __slots__ = ("_segments", "_total", "trace")

    def __init__(self, value: Any, trace: bytes = b""):
        header, raws = _pickle_oob(value)
        total, hoff, boffs, idx = frame_layout(len(header),
                                               [r.nbytes for r in raws],
                                               trace)
        self.trace = trace
        prefix = bytearray(hoff + len(header))
        prefix[0:4] = FRAME_MAGIC
        prefix[4:8] = _struct.pack(">I", len(idx))
        prefix[8:8 + len(idx)] = idx
        prefix[hoff:] = header
        segments = [(0, memoryview(prefix).toreadonly())]
        for off, r in zip(boffs, raws):
            segments.append((off, r.toreadonly()))
        self._segments = segments
        self._total = total

    def __len__(self) -> int:
        return self._total

    @property
    def pieces(self) -> List[memoryview]:
        """The whole frame as a contiguous-coverage gather list."""
        return self.slices(0, self._total)

    def slices(self, start: int, end: int) -> List[memoryview]:
        """Gather list covering exactly ``[start, min(end, len))`` of the
        frame; alignment padding appears as zero-filled pieces."""
        end = min(end, self._total)
        out: List[memoryview] = []
        pos = start
        for off, mv in self._segments:
            if pos >= end:
                break
            gap_end = min(off, end)
            while pos < gap_end:  # zeros between segments (< 64 bytes)
                take = min(len(_PAD), gap_end - pos)
                out.append(memoryview(_PAD)[:take])
                pos += take
            seg_end = off + len(mv)
            if pos < seg_end and pos < end:
                lo, hi = pos - off, min(seg_end, end) - off
                out.append(mv[lo:hi])
                pos = off + hi
        while pos < end:  # trailing pad up to the 64-aligned total
            take = min(len(_PAD), end - pos)
            out.append(memoryview(_PAD)[:take])
            pos += take
        return out

    def write_into(self, dest: memoryview) -> None:
        """Materialize the frame into ``dest`` (arena slot landing)."""
        pos = 0
        for p in self.pieces:
            n = len(p)
            dest[pos:pos + n] = p
            pos += n
