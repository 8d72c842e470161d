"""Dependency-free TensorBoard event writer.

A copy of the JAX package's ``utils/tb_writer.py`` (until ROADMAP A0 gives
both packages one JAX-free home for it); ``tests/test_torch_train.py``
holds the two to the same bytes.

The reference logs through torch's SummaryWriter (reference train.py:158-159,
255-271): per-epoch scalars (lr, loss, accuracy, aux loss, selection loss,
rejection ratio) and first-5 input/label/pred/selection image panels, into
``{model_dir}/{fold}-fold/log/{train,valid}``. This module reproduces that
observability surface by writing the TensorBoard wire format directly —
TFRecord framing (length + masked CRC32C) around hand-encoded Event/Summary
protobufs — so logging needs neither tensorboard nor TF. Files are readable
by stock TensorBoard (the JAX copy is validated in tests/test_tb_writer.py
against the tensorboard/TF reader). PIL is imported only to encode images.

Supported summaries: ``add_scalar`` and ``add_images`` (NHWC uint8/float,
PNG-encoded), which is the full set the reference uses.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), reflected, table-driven — required by TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_poly = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _poly if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _pb_string(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


# Event proto: 1=wall_time(double) 2=step(int64) 3=file_version(string) 5=summary
# Summary proto: repeated 1=Value; Value: 1=tag 2=simple_value(float) 4=image
# Summary.Image: 1=height 2=width 3=colorspace 4=encoded_image_string


def _event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _pb_double(1, wall_time)
    if step:
        msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_string(3, file_version)
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_string(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


def _png_encode(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _image_summary(tag: str, img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    colorspace = 1 if img.ndim == 2 else img.shape[2]
    image_msg = (
        _pb_varint(1, h) + _pb_varint(2, w) + _pb_varint(3, colorspace)
        + _pb_bytes(4, _png_encode(img))
    )
    val = _pb_string(1, tag) + _pb_bytes(4, image_msg)
    return _pb_bytes(1, val)


class SummaryWriter:
    """TensorBoard event-file writer (torch SummaryWriter API subset)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._lock = threading.Lock()
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        rec = (
            header
            + struct.pack("<I", masked_crc32c(header))
            + payload
            + struct.pack("<I", masked_crc32c(payload))
        )
        with self._lock:
            self._file.write(rec)
            self._file.flush()

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        self._write_record(
            _event(time.time(), step=int(global_step), summary=_scalar_summary(tag, value))
        )

    def add_images(self, tag: str, images: np.ndarray, global_step: int = 0,
                   dataformats: str = "NHWC") -> None:
        """First-5-panel image logging (reference train.py:266-271 convention:
        NHWC float in [0, 1] or uint8)."""
        assert dataformats == "NHWC", "NHWC is the only supported layout"
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
        summary = b""
        for i, img in enumerate(images):
            if img.ndim == 3 and img.shape[2] == 1:
                img = img[:, :, 0]
            elif img.ndim == 3 and img.shape[2] == 2:
                # 2-channel (GH: gray + hematoxylin) panels: PIL has no
                # 2-band mode — render the channels side by side as one
                # grayscale strip instead of crashing the epoch
                img = np.concatenate([img[:, :, 0], img[:, :, 1]], axis=1)
            summary += _image_summary(f"{tag}/{i}", img)
        self._write_record(_event(time.time(), step=int(global_step), summary=summary))

    def flush(self) -> None:
        with self._lock:
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()
                self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
