"""ctypes bindings for the native C++ patch decoder (``native/patch_decoder.cpp``).

The port's own bindings, counterpart of the JAX package's
``data/native_decoder.py:1-167``. The C++ source is the repo's
``native/patch_decoder.cpp``, read and never written: the port builds it
with the same command (``BUILD_CMD``) into its own git-ignored
``kernels/_build/libpatch_decoder.so``. It decodes an (input JPEG, label
PNG) pair straight into numpy buffers, the input as float32 in [0, 1]
(``src * (1.0f / 255.0f)``) or raw uint8, the label as uint8 {0, 1}, with the
GIL released for the whole call, so ``PatchLoader``'s thread pool decodes in
parallel.

* The build is published atomically: compiled to a per-process temporary
  name and renamed into place, so a concurrent process never loads a
  half-written library, and a failed build leaves nothing behind.
* A library older than its source is rebuilt; where that rebuild fails,
  the stale library is refused with a ``RuntimeWarning`` (a fix to the C++
  with an unchanged ABI must never decode with the old code).
* The library must report ABI version 3 (``decoder_abi_version``).

Where the toolchain or libjpeg/libpng are missing, ``available()`` is
False and ``build_error()`` holds the compiler's last error line; a
``PatchDataset(decoder="auto")`` then decodes with PIL, as in JAX, and
``decoder="native"`` raises. Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

from ..kernels import BUILD_DIR

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "patch_decoder.cpp")
LIBRARY = os.path.join(BUILD_DIR, "libpatch_decoder.so")
ABI_VERSION = 3  # decoder_abi_version() in patch_decoder.cpp

# the JAX package's BUILD_CMD, flag for flag
BUILD_CMD = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
             "{src}", "-o", "{out}", "-ljpeg", "-lpng"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False
_build_error: Optional[str] = None


def _build() -> bool:
    """Compile ``SOURCE`` into ``LIBRARY``; False (and ``_build_error`` set)
    where it fails."""
    global _build_error
    if not os.path.exists(SOURCE):
        _build_error = f"{SOURCE} is missing"
        return False
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.build.{os.getpid()}"
    cmd = [a.format(src=SOURCE, out=tmp) for a in BUILD_CMD]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            os.replace(tmp, LIBRARY)
            return True
        lines = (proc.stderr or proc.stdout or "").strip().splitlines()
        # the compiler's last error line ("fatal error: jpeglib.h: No such
        # file or directory"), not its closing "compilation terminated."
        errors = [ln for ln in lines if "error" in ln]
        _build_error = (errors or lines or [f"{cmd[0]} exited with {proc.returncode}"])[-1]
    except (OSError, subprocess.SubprocessError) as e:
        _build_error = f"{type(e).__name__}: {e}"
    if os.path.exists(tmp):
        os.unlink(tmp)
    return False


def _stale() -> bool:
    try:
        return os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)
    except OSError:
        return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if _stale() and not _build():
            if os.path.exists(LIBRARY):
                warnings.warn(
                    f"{LIBRARY} is older than {SOURCE} and the rebuild failed "
                    f"({_build_error}); the stale library is refused and decoding "
                    "falls back to PIL", RuntimeWarning, stacklevel=3)
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(LIBRARY)
            for name, out_type in (("decode_patch_pair", ctypes.c_float),
                                   ("decode_patch_pair_u8", ctypes.c_uint8)):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.POINTER(out_type), ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_int, ctypes.c_int]
            abi = lib.decoder_abi_version()
            if abi != ABI_VERSION:
                raise OSError(f"ABI version {abi}, expected {ABI_VERSION}")
        except (OSError, AttributeError) as e:
            # a library without the symbols or of another ABI: PIL, not a crash
            _build_error = f"{LIBRARY}: {e}"
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the decoder is built (building it on the first call) and loads."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The failed build's last error line (else its last line), or None."""
    return _build_error


def _failed_path(rc: int, input_path: str, label_path: str) -> str:
    """Codes -2..-4 are the JPEG's, -5..-8 the PNG's (patch_decoder.cpp)."""
    return label_path if rc <= -5 else input_path


def _decode(fn_name: str, input_path: str, label_path: str, size: int,
            dtype) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    inp = np.empty((size, size, 3), dtype)
    lab = np.empty((size, size), np.uint8)
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_uint8
    rc = getattr(lib, fn_name)(
        input_path.encode(), label_path.encode(),
        inp.ctypes.data_as(ctypes.POINTER(ctype)),
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size, size)
    if rc != 0:
        raise RuntimeError(f"native decode failed (code {rc}) for "
                           f"{_failed_path(rc, input_path, label_path)}")
    return inp, lab


def decode_patch_pair(input_path: str, label_path: str,
                      size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(input (size, size, 3) float32 in [0, 1], label (size, size) uint8
    {0, 1}); raises RuntimeError with the native code on failure (the
    dataset then decodes that pair with PIL)."""
    return _decode("decode_patch_pair", input_path, label_path, size, np.float32)


def decode_patch_pair_u8(input_path: str, label_path: str,
                         size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The raw feed's decode: input uint8 RGB, label uint8 {0, 1}."""
    return _decode("decode_patch_pair_u8", input_path, label_path, size, np.uint8)
