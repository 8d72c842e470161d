"""Dependency-free TensorBoard scalar reader, the inverse of tb_writer.py.

The port's own copy of the JAX package's ``utils/tb_reader.py:26-106`` (the
port imports nothing of the JAX package); ``tests/test_torch_tb_reader.py``
holds the two to the same results on event files of either writer.

It parses the two layers ``utils/tb_writer.py`` emits:

* TFRecord framing: <u64 length><u32 masked-crc(header)><payload>
  <u32 masked-crc(payload)> (tb_writer.SummaryWriter._write_record);
* Event proto subset: wall_time (field 1, double), step (field 2, varint),
  summary (field 5) -> Value (field 1) -> tag (field 1, string) /
  simple_value (field 2, float) (tb_writer._event/_scalar_summary).

Unknown fields (e.g. image summaries) are skipped structurally.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Dict, List, Tuple


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:          # varint
            v, i = _read_varint(buf, i)
        elif wire == 1:        # 64-bit
            v = buf[i:i + 8]
            i += 8
        elif wire == 2:        # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:        # 32-bit
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _records(path: str):
    """Yield TFRecord payloads (CRCs are trusted — we wrote them)."""
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        (length,) = struct.unpack("<Q", data[i:i + 8])
        payload = data[i + 12:i + 12 + length]
        if len(payload) < length:
            break  # truncated tail (writer died mid-record): stop cleanly
        yield payload
        i += 12 + length + 4


def read_scalars(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """All scalar events under ``log_dir`` -> {tag: [(step, value), ...]},
    step-ordered, concatenated across event files (restarted runs append a
    new file; reference resume keeps the old ones)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for path in sorted(glob.glob(os.path.join(log_dir,
                                              "events.out.tfevents.*"))):
        for payload in _records(path):
            step = 0
            summary = None
            for field, wire, v in _fields(payload):
                if field == 2 and wire == 0:
                    step = v
                elif field == 5 and wire == 2:
                    summary = v
            if summary is None:
                continue
            for field, wire, v in _fields(summary):
                if field != 1 or wire != 2:
                    continue
                tag = None
                value = None
                for f2, w2, v2 in _fields(v):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode("utf-8", "replace")
                    elif f2 == 2 and w2 == 5:
                        (value,) = struct.unpack("<f", v2)
                if tag is not None and value is not None:
                    out.setdefault(tag, []).append((int(step), float(value)))
    for tag in out:
        out[tag].sort(key=lambda sv: sv[0])
    return out
