"""TFRecord file format + tf.train.Example codec, dependency-free.

Parity with ``python/ray/data/read_api.py read_tfrecords`` /
``Dataset.write_tfrecords`` (the reference rides tensorflow; this
runtime hand-rolls the two stable public formats so the input
pipeline needs no TF install):

- **TFRecord framing**: ``uint64le length | u32 masked_crc32c(length) |
  data | u32 masked_crc32c(data)`` with CRC32C (Castagnoli) and the
  TFRecord mask ``((crc >> 15) | (crc << 17)) + 0xa282ead8``.
- **tf.train.Example**: the three-field protobuf schema
  (bytes_list/float_list/int64_list per feature), encoded/decoded with
  a minimal varint wire codec — the schema is frozen public API, small
  enough that a hand codec is sturdier than a TF dependency.

Corrupt records fail loudly (CRC mismatch raises), matching TF's
reader behavior.

Port of ``ray_tpu/data/tfrecords.py``, unchanged: files written by
either package are equal byte for byte.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Iterator, List

import numpy as np

# ---------------------------------------------------------------- crc32c

def _build_crc_tables() -> List[List[int]]:
    """Slice-by-8 tables: table[0] is the classic byte table; table[k]
    advances a byte through k additional zero bytes — 8 bytes per loop
    iteration instead of 1 (~6x over per-byte pure Python, keeping the
    codec dependency-free)."""
    poly = 0x82F63B78
    base = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        base.append(c)
    tables = [base]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([(prev[i] >> 8) ^ base[prev[i] & 0xFF]
                       for i in range(256)])
    return tables


# Built eagerly at import: concurrent writer tasks share this module, and
# a lazily-appended global would race (interleaved appends => corrupt
# CRCs in every file written afterwards).
_CRC_TABLES: List[List[int]] = _build_crc_tables()


def crc32c(data: bytes) -> int:
    t0, t1, t2, t3, t4, t5, t6, t7 = _CRC_TABLES
    crc = 0xFFFFFFFF
    n8 = len(data) & ~7
    i = 0
    while i < n8:
        crc ^= (data[i] | data[i + 1] << 8 | data[i + 2] << 16
                | data[i + 3] << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[crc >> 24]
               ^ t3[data[i + 4]] ^ t2[data[i + 5]]
               ^ t1[data[i + 6]] ^ t0[data[i + 7]])
        i += 8
    for b in data[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ tfrecord IO

def write_tfrecord_file(path: str, records: Iterable[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


def read_tfrecord_file(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header)
            hcrc_b = f.read(4)
            if len(hcrc_b) != 4:
                raise ValueError(f"{path}: truncated header CRC")
            if struct.unpack("<I", hcrc_b)[0] != _masked_crc(header):
                raise ValueError(f"{path}: corrupt record header CRC")
            data = f.read(length)
            if len(data) != length:
                raise ValueError(f"{path}: truncated record data")
            dcrc_b = f.read(4)
            if len(dcrc_b) != 4:
                raise ValueError(f"{path}: truncated data CRC")
            if struct.unpack("<I", dcrc_b)[0] != _masked_crc(data):
                raise ValueError(f"{path}: corrupt record data CRC")
            yield data


# ------------------------------------------------- minimal protobuf wire

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


# --------------------------------------------------- tf.train.Example

def encode_example(row: Dict[str, Any]) -> bytes:
    """dict -> serialized Example. Value typing: bytes/str -> BytesList,
    float -> FloatList, int/bool -> Int64List; lists of those likewise."""
    feats = bytearray()
    for name, value in row.items():
        if isinstance(value, np.ndarray):
            values: Any = value.tolist()
        elif isinstance(value, (list, tuple)):
            values = list(value)
        else:
            values = [value]
        first = values[0] if values else 0
        if isinstance(first, (bytes, str)):
            payload = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v)
                for v in values)
            feature = _ld(1, payload)           # BytesList in field 1
        elif isinstance(first, (float, np.floating)):
            floats = [float(v) for v in values]
            packed = struct.pack(f"<{len(floats)}f", *floats)
            feature = _ld(2, _varint(8 | 2) + _varint(len(packed))
                          + packed)             # FloatList packed field 1
        else:
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                              for v in values)
            feature = _ld(3, _varint(8 | 2) + _varint(len(packed))
                          + packed)             # Int64List packed field 1
        entry = _ld(1, name.encode()) + _ld(2, feature)
        feats += _ld(1, entry)                  # map entry
    return bytes(_ld(1, bytes(feats)))          # Example.features


def _decode_list(buf: bytes):
    """Decode one of BytesList/FloatList/Int64List given its kind tag."""
    kind, pos = _read_varint(buf, 0)
    field = kind >> 3
    ln, pos = _read_varint(buf, pos)
    payload = buf[pos:pos + ln]
    if field == 1:    # BytesList
        out = []
        p = 0
        while p < len(payload):
            tag, p = _read_varint(payload, p)
            vlen, p = _read_varint(payload, p)
            out.append(payload[p:p + vlen])
            p += vlen
        return out
    if field == 2:    # FloatList
        if not payload:
            return []  # TF serializes an empty value list as len-0
        inner_tag, p = _read_varint(payload, 0)
        if inner_tag & 7 == 2:  # packed
            plen, p = _read_varint(payload, p)
            data = payload[p:p + plen]
            return list(struct.unpack(f"<{len(data) // 4}f", data))
        out = []
        p = 0
        while p < len(payload):
            tag, p = _read_varint(payload, p)
            out.append(struct.unpack("<f", payload[p:p + 4])[0])
            p += 4
        return out
    # Int64List
    if not payload:
        return []  # TF serializes an empty value list as len-0
    inner_tag, p = _read_varint(payload, 0)
    out = []
    if inner_tag & 7 == 2:  # packed
        plen, p = _read_varint(payload, p)
        end = p + plen
        while p < end:
            v, p = _read_varint(payload, p)
            out.append(v - (1 << 64) if v >= (1 << 63) else v)
        return out
    p = 0
    while p < len(payload):
        tag, p = _read_varint(payload, p)
        v, p = _read_varint(payload, p)
        out.append(v - (1 << 64) if v >= (1 << 63) else v)
    return out


def decode_example(data: bytes) -> Dict[str, Any]:
    """serialized Example -> dict (single values unwrapped)."""
    row: Dict[str, Any] = {}
    tag, pos = _read_varint(data, 0)        # Example.features
    flen, pos = _read_varint(data, pos)
    feats = data[pos:pos + flen]
    p = 0
    while p < len(feats):
        tag, p = _read_varint(feats, p)     # map entry
        elen, p = _read_varint(feats, p)
        entry = feats[p:p + elen]
        p += elen
        q = 0
        name = None
        values: Any = None
        while q < len(entry):
            etag, q = _read_varint(entry, q)
            eln, q = _read_varint(entry, q)
            payload = entry[q:q + eln]
            q += eln
            if etag >> 3 == 1:
                name = payload.decode()
            else:
                values = _decode_list(payload)
        if name is not None:
            row[name] = values[0] if values and len(values) == 1 else values
    return row
