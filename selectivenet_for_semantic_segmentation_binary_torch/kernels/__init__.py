"""Hand-written Hopper kernels of the port, and their build.

Each kernel is one CUDA C++ source in this directory with a plain
``extern "C"`` launcher. At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``_build/`` and loaded with ``ctypes``; it is rebuilt when
the source is newer than the library. Importing this module builds and
loads nothing, so the package imports on a machine without ``nvcc`` or a
card. A failed build or load raises with the compiler's output: no wrapper
falls back to its plain version.

Same build / atomic-rename / load pattern as the JAX package's
``data/native_decoder.py:32-113``, without its fallback. PyTorch's
``cpp_extension.load`` is not used: it needs ``ninja``, and a source that
includes PyTorch's headers takes minutes to compile.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")

# No --use_fast_math: eval_metrics.cu must reproduce torch.sigmoid's precise
# expf and IEEE division bit for bit.
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: dict = {}
_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(KERNEL_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin "
                       "(default /usr/local/cuda): the port's kernels are "
                       "built from source at first use")


def _stale(name: str) -> bool:
    try:
        return (os.path.getmtime(library_path(name))
                < os.path.getmtime(source_path(name)))
    except OSError:
        return True


def build(name: str) -> str:
    """Compile ``{name}.cu`` into ``_build/lib{name}.so`` unless an up-to-date
    library is there; return the library's path. The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills) is kept in
    ``_build/{name}.log``."""
    src = source_path(name)
    if not os.path.exists(src):
        raise FileNotFoundError(f"kernel source {src} is missing")
    out = library_path(name)
    if not _stale(name):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process temp name, then an atomic rename: a concurrent process
    # never loads a half-written library
    tmp = f"{out}.build.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib{name}.so`` once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
