"""Hand-written Hopper kernels of the port, and their build.

Each kernel is one CUDA C++ source in this directory with a plain
``extern "C"`` launcher; device code that several share is in
``common.cuh``. At first use it is compiled with ``nvcc`` for ``sm_90a``
into ``_build/`` and loaded with ``ctypes``; it is rebuilt when the source
or a header is newer than the library. Importing this module builds and
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
    """Whether the library is missing or older than its source or any of the
    shared headers (``*.cuh``) the sources include."""
    headers = [os.path.join(KERNEL_DIR, f) for f in os.listdir(KERNEL_DIR) if f.endswith(".cuh")]
    try:
        return os.path.getmtime(library_path(name)) < max(
            os.path.getmtime(p) for p in [source_path(name), *headers])
    except OSError:
        return True


def build(name: str) -> str:
    """Compile ``{name}.cu`` into ``_build/lib{name}.so`` unless an up-to-date
    library is there; return the library's path. The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills) is kept in
    ``_build/{name}.log``."""
    return build_all([name])[0]


def build_all(names) -> list:
    """``build`` for several kernels, one ``nvcc`` each, all started
    together; raises after all have ended if any failed."""
    jobs = []
    for name in names:
        src = source_path(name)
        if not os.path.exists(src):
            raise FileNotFoundError(f"kernel source {src} is missing")
        if not _stale(name):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per-process temp name, then an atomic rename: a concurrent process
        # never loads a half-written library
        tmp = f"{library_path(name)}.build.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, src, "-o", tmp]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((name, src, tmp, cmd, proc))
    errors = []
    for name, src, tmp, cmd, proc in jobs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            errors.append(f"nvcc failed to build {src} (exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, library_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(name) for name in names]


def build_other(src: str, name: str) -> ctypes.CDLL:
    """Another build of a kernel (``src``, for example another commit's
    source), compiled with these flags into ``_build/lib{name}_other.so`` and
    loaded; the scripts that time two builds in one run use it."""
    if not os.path.exists(src):
        raise FileNotFoundError(f"kernel source {src} is missing")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}_other.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, src, "-o", out], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n{proc.stderr}")
    return ctypes.CDLL(out)


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib{name}.so`` once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
