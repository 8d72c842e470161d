"""The port's native decoder (``data/native_decoder.py``): its own build of
``native/patch_decoder.cpp`` against the JAX package's, and its build rules.

* The port's library decodes every pair of a synthetic tree bit for bit as
  the JAX package's does (float32 inputs, uint8 inputs, labels), and the
  port's ``PatchDataset(decoder="native")`` equals JAX's.
* The default decoder is PIL, also where the native library builds.
* ``decoder="auto"`` falls back to PIL when the build fails, and
  ``"native"`` then raises; a stale library is refused after a failed
  rebuild; a library of another ABI is refused; a build, failed or not,
  leaves nothing but the library; ``native/`` is never written.

Each rule runs on a build into a temporary directory (``LIBRARY`` and
``SOURCE`` pointed there), so the package's own ``kernels/_build/`` is left
as it is.
"""

import os
import shutil

import numpy as np
import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.data import (
    PatchDataset as JaxPatchDataset, construct_test)
from selectivenet_for_semantic_segmentation_binary_tpu.data import native_decoder as jax_nd
from selectivenet_for_semantic_segmentation_binary_torch.data import native_decoder as nd
from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    write_synthetic_patch_tree)

SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
BUILD_CMD = list(nd.BUILD_CMD)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_native_data"))
    write_synthetic_patch_tree(d, n_slides=2, patches_per_slide=8, patch_size=SIZE, seed=6)
    return d


def _fresh(monkeypatch, lib_dir, source=nd.SOURCE, build_cmd=None):
    """Point the module at a library in ``lib_dir`` with nothing loaded."""
    monkeypatch.setattr(nd, "LIBRARY", os.path.join(str(lib_dir), "libpatch_decoder.so"))
    monkeypatch.setattr(nd, "SOURCE", str(source))
    if build_cmd is not None:
        monkeypatch.setattr(nd, "BUILD_CMD", build_cmd)
    monkeypatch.setattr(nd, "_lib", None)
    monkeypatch.setattr(nd, "_build_failed", False)
    monkeypatch.setattr(nd, "_build_error", None)


def _tracked_native_files():
    """(name, mtime, bytes) of the repo's own files in native/ (the JAX
    package's built library beside them is not the port's)."""
    out = []
    for name in sorted(os.listdir(NATIVE)):
        path = os.path.join(NATIVE, name)
        if os.path.isfile(path) and not name.startswith("libpatch_decoder.so"):
            with open(path, "rb") as f:
                out.append((name, os.stat(path).st_mtime_ns, f.read()))
    return out


@pytest.fixture(scope="module")
def both_built():
    if not (nd.available() and jax_nd.available()):
        pytest.skip(f"no C++ toolchain with libjpeg/libpng here: {nd.build_error()}")


def test_the_library_lives_in_the_ports_build_directory():
    assert os.path.dirname(nd.LIBRARY) == os.path.join(
        REPO, "selectivenet_for_semantic_segmentation_binary_torch", "kernels", "_build")
    assert nd.SOURCE == os.path.join(NATIVE, "patch_decoder.cpp")
    assert nd.BUILD_CMD == jax_nd.BUILD_CMD and nd.ABI_VERSION == jax_nd._ABI_VERSION


@pytest.mark.parametrize("fn", ["decode_patch_pair", "decode_patch_pair_u8"])
def test_the_port_build_decodes_bit_equal_to_jax(both_built, data_dir, fn):
    test = construct_test(data_dir, 1)
    ds = PatchDataset(data_dir, test, 200, SIZE, decoder="pil")
    assert len(ds) >= 3
    for i in range(len(ds)):
        paths = (os.path.join(ds.patch_dir, ds.input_list[i]),
                 os.path.join(ds.patch_dir, ds.label_list[i]))
        got, want = getattr(nd, fn)(*paths, SIZE), getattr(jax_nd, fn)(*paths, SIZE)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_native_datasets_equal_jax(both_built, data_dir):
    test = construct_test(data_dir, 1)
    ds = PatchDataset(data_dir, test, 200, SIZE, decoder="native")
    jds = JaxPatchDataset(data_dir, test, 200, SIZE, decoder="native")
    assert ds.use_native
    for i in range(len(ds)):
        for g, w in zip(ds.get_raw(i), jds.get_raw(i)):
            assert np.array_equal(g, w)
        g, w = ds[i], jds[i]
        assert g["id"] == w["id"]
        assert np.array_equal(g["input"], w["input"]) and np.array_equal(g["label"], w["label"])


def test_the_default_decodes_with_pil_where_the_native_build_works(both_built, data_dir):
    test = construct_test(data_dir, 1)
    assert PatchDataset(data_dir, test, 200, SIZE, decoder="auto").use_native
    default = PatchDataset(data_dir, test, 200, SIZE)
    assert not default.use_native
    pil = JaxPatchDataset(data_dir, test, 200, SIZE, decoder="pil")
    for i in range(len(default)):
        for g, w in zip(default.get_raw(i), pil.get_raw(i)):
            assert np.array_equal(g, w)


def test_auto_falls_back_to_pil_when_the_build_fails(data_dir, tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path, build_cmd=["false"])
    test = construct_test(data_dir, 1)
    auto = PatchDataset(data_dir, test, 200, SIZE, decoder="auto")
    assert not auto.use_native and not nd.available() and nd.build_error()
    pil = PatchDataset(data_dir, test, 200, SIZE, decoder="pil")
    for g, w in zip(auto.get_raw(0), pil.get_raw(0)):
        assert np.array_equal(g, w)
    assert np.array_equal(auto[0]["input"], pil[0]["input"])
    with pytest.raises(RuntimeError, match="native decoder requested but unavailable"):
        PatchDataset(data_dir, test, 200, SIZE, decoder="native")
    with pytest.raises(RuntimeError, match="unavailable"):
        nd.decode_patch_pair("a.jpg", "a.png", SIZE)
    assert os.listdir(tmp_path) == []


def test_a_stale_library_is_refused(tmp_path, monkeypatch):
    src = tmp_path / "patch_decoder.cpp"
    shutil.copy(nd.SOURCE, src)
    _fresh(monkeypatch, tmp_path / "lib", source=src)
    if not nd.available():
        pytest.skip(f"no C++ toolchain with libjpeg/libpng here: {nd.build_error()}")
    lib = nd.LIBRARY
    old = os.stat(src).st_mtime - 100
    os.utime(lib, (old, old))  # now older than its source
    _fresh(monkeypatch, tmp_path / "lib", source=src, build_cmd=["false"])
    with pytest.warns(RuntimeWarning, match="stale library is refused"):
        assert not nd.available()
    assert nd._lib is None and os.path.exists(lib)
    _fresh(monkeypatch, tmp_path / "lib", source=src, build_cmd=BUILD_CMD)
    assert nd.available()  # a working compiler rebuilds it
    assert os.stat(lib).st_mtime >= os.stat(src).st_mtime


def test_a_library_of_another_abi_is_refused(tmp_path, monkeypatch):
    src = tmp_path / "abi2.cpp"
    src.write_text('extern "C" int decoder_abi_version() { return 2; }\n'
                   'extern "C" int decode_patch_pair() { return 0; }\n'
                   'extern "C" int decode_patch_pair_u8() { return 0; }\n')
    _fresh(monkeypatch, tmp_path / "lib", source=src,
           build_cmd=["g++", "-O0", "-fPIC", "-shared", "{src}", "-o", "{out}"])
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    assert not nd.available()
    assert "ABI version 2, expected 3" in nd.build_error()


def test_the_build_leaves_no_droppings(tmp_path, monkeypatch):
    before = _tracked_native_files()
    _fresh(monkeypatch, tmp_path / "ok")
    built = nd.available()
    assert sorted(os.listdir(tmp_path / "ok")) == (["libpatch_decoder.so"] if built else [])
    # a compiler that writes its output and then fails, as g++ fails without
    # libjpeg's headers: the error line is kept, not the closing line
    _fresh(monkeypatch, tmp_path / "failed", build_cmd=[
        "sh", "-c", "echo partial > {out}; echo 'x.cpp:27:10: fatal error: jpeglib.h: No such "
        "file or directory' >&2; echo 'compilation terminated.' >&2; exit 1"])
    assert not nd.available()
    assert nd.build_error() == "x.cpp:27:10: fatal error: jpeglib.h: No such file or directory"
    assert os.listdir(tmp_path / "failed") == []
    assert _tracked_native_files() == before  # native/ is read, never written


def test_native_is_untouched_by_the_default_build():
    """The package's own build (``kernels/_build/``) reads native/'s source
    and writes nothing there: the repo's files in native/ keep their bytes
    and mtimes, and no file of the port's build lands there."""
    before = _tracked_native_files()
    nd.available()
    assert _tracked_native_files() == before
    assert not os.path.commonpath([nd.LIBRARY, NATIVE]) == NATIVE
