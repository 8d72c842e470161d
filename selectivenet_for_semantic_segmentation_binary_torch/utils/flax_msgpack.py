"""A pure-Python decoder for the msgpack that flax writes.

The JAX package saves its ``.ckpt`` files with flax's ``msgpack_serialize``
(JAX ``utils/checkpoint.py::save_checkpoint``). ``utils/checkpoint.py``
decodes them with :func:`unpackb` whether or not the ``msgpack`` package
imports; the tests hold it to ``msgpack`` with flax's own ext hook.

Only the subset flax's encoder emits is decoded:

* fix/16/32 maps and arrays (arrays come back as lists, as ``msgpack``'s
  ``use_list`` default gives them); fix/8/16/32 str and bin;
* positive and negative fixint, uint8-64 and int8-64, float32 and float64,
  nil, true and false;
* fixext 1-16 and ext8/16/32 of type 1 (an ndarray) and 3 (a numpy
  scalar), each a packed ``(shape, dtype name, bytes)``; type 2 (a complex)
  and any other type raise ``ValueError``.

An ndarray is a read-only ``numpy.frombuffer`` view of the file's bytes: the
payloads are sliced, never copied byte by byte (the full-width UNet_B
checkpoint with its Adam state is hundreds of MB).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

# flax.serialization._MsgpackExtType
EXT_NDARRAY = 1
EXT_NPSCALAR = 3

_INT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
        0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
        0xca: ">f", 0xcb: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {  # code -> (kind, width of its length field)
    0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
    0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
    0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
    0xdc: ("array", 2), 0xdd: ("array", 4),
    0xde: ("map", 2), 0xdf: ("map", 4),
}


class _Decoder:
    def __init__(self, data) -> None:
        view = memoryview(data)
        self.buf = view.cast("B") if view.format != "B" or view.ndim != 1 else view

    def _take(self, pos: int, n: int) -> Tuple[memoryview, int]:
        end = pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[pos:end], end

    def _unpack(self, fmt: str, pos: int) -> Tuple[Any, int]:
        size = struct.calcsize(fmt)
        self._take(pos, size)
        return struct.unpack_from(fmt, self.buf, pos)[0], pos + size

    def value(self, pos: int, views: bool = False) -> Tuple[Any, int]:
        """(the object at ``pos``, the position after it). ``views`` keeps
        bin payloads as memoryviews (inside an ext); else they are bytes,
        as ``msgpack`` gives them."""
        b, pos = self._unpack(">B", pos)
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if b <= 0x8f:
            return self._map(pos, b & 0x0f, views)
        if b <= 0x9f:
            return self._array(pos, b & 0x0f, views)
        if b <= 0xbf:
            return self._str(pos, b & 0x1f)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in _INT:
            return self._unpack(_INT[b], pos)
        if b in _FIXEXT:
            return self._ext(pos, _FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n, pos = self._unpack(_LEN[width], pos)
            if kind == "bin":
                payload, pos = self._take(pos, n)
                return (payload if views else bytes(payload)), pos
            if kind == "ext":
                return self._ext(pos, n)
            if kind == "str":
                return self._str(pos, n)
            if kind == "array":
                return self._array(pos, n, views)
            return self._map(pos, n, views)
        raise ValueError(f"msgpack code 0x{b:02x} is not used by flax's encoder")

    def _str(self, pos: int, n: int) -> Tuple[str, int]:
        raw, pos = self._take(pos, n)
        return bytes(raw).decode("utf-8"), pos

    def _array(self, pos: int, n: int, views: bool) -> Tuple[list, int]:
        out = []
        for _ in range(n):
            item, pos = self.value(pos, views)
            out.append(item)
        return out, pos

    def _map(self, pos: int, n: int, views: bool) -> Tuple[dict, int]:
        out = {}
        for _ in range(n):
            key, pos = self.value(pos, views)
            out[key], pos = self.value(pos, views)
        return out, pos

    def _ext(self, pos: int, n: int) -> Tuple[Any, int]:
        code, pos = self._unpack(">b", pos)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")
        end = pos + n
        self._take(pos, n)
        (shape, dtype_name, buf), stop = self.value(pos, views=True)
        if stop != end:
            raise ValueError("malformed msgpack ext payload")
        if isinstance(dtype_name, memoryview):
            dtype_name = bytes(dtype_name).decode()
        # as flax restores it: an ndarray (type 1) or a numpy scalar (type 3)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)
        return (arr[()] if code == EXT_NPSCALAR else arr), end


def unpackb(data) -> Any:
    """Decode one msgpack object that fills ``data`` (bytes, bytearray or
    a buffer)."""
    decoder = _Decoder(data)
    obj, end = decoder.value(0)
    if end != len(decoder.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return obj
