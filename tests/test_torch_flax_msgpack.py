"""Reading the JAX package's ``.ckpt`` files without ``msgpack``
(``utils/flax_msgpack.py``, the decoder ``utils/checkpoint.load_flax_msgpack``
always uses). The reference is ``msgpack`` with flax's own ext hook
(``_by_msgpack``), refusing the ext types flax checkpoints do not hold.

* A ``.ckpt`` that JAX ``save_checkpoint`` wrote for the selective UNet_B,
  with its Adam state, decodes to the same pytree (keys, types, dtypes,
  shapes, values) with ``msgpack`` blocked (``sys.modules["msgpack"] =
  None``) as the reference gives; ``snet-eval`` of its directory runs
  blocked and prints what it prints with ``msgpack`` importable.
* The committed fixture ``tests/data/jax_fixture.ckpt`` (written by JAX
  ``save_checkpoint``; ``_fixture_state`` is its content) decodes to the
  arrays of ``tests/data/jax_fixture.npz`` with ``msgpack`` importable and
  blocked. ``save_checkpoint``
  turns every leaf into an ndarray (its numpy scalar becomes a 0-d array,
  and a string leaf would become a 'str32' array that flax itself cannot
  restore), so the fixture's strings are its keys.
* Every msgpack form of flax's subset, from flax's own ``msgpack_serialize``,
  decodes as ``msgpack`` does; ext type 2 (complex) and other types raise
  the same ``ValueError``; truncated data raises; ndarray payloads are views
  of the file's bytes, not copies.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    save_checkpoint, torch_state_dict_to_variables)
from selectivenet_for_semantic_segmentation_binary_torch import cli
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    seeded_model, write_synthetic_patch_tree)
from selectivenet_for_semantic_segmentation_binary_torch.utils import checkpoint as ck
from selectivenet_for_semantic_segmentation_binary_torch.utils import flax_msgpack

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURE = os.path.join(DATA, "jax_fixture.ckpt")
FIXTURE_NPZ = os.path.join(DATA, "jax_fixture.npz")
SIZE = 32


def _fixture_state():
    rng = np.random.default_rng(11)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "net": {"params": {"enc1_1": {"conv": {"kernel": f32(3, 3, 2, 8), "bias": f32(8)}},
                           "head": {"kernel": f32(1, 1, 8, 1)}},
                "batch_stats": {"enc1_1": {"bn": {"mean": f32(8), "var": np.abs(f32(8))}}}},
        "optim": {"0": {"count": np.int32(7), "mu": {"w": f32(2000)}}},
        "steps": rng.integers(-2**31, 2**31 - 1, 300).astype(np.int32),
        "scale": np.float32(0.25),  # a numpy scalar
        "epoch": 12,
        "scheduler": {"lr": 1e-3, "best": None},
        "a key longer than thirty-one characters, and not ASCII: Hämatoxylin": {"x": f32(3)},
    }


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _same_tree(a, b, path="/"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}{k}/")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}{i}/")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _msgpack_ext(code: int, data: bytes):
    """flax's own ext hook, refusing what a flax checkpoint does not hold
    (type 2, a complex, and any type flax does not write)."""
    if code not in (flax_msgpack.EXT_NDARRAY, flax_msgpack.EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")
    return serialization._msgpack_ext_unpack(code, data)


def _by_msgpack(data):
    return msgpack.unpackb(data, ext_hook=_msgpack_ext, raw=False)


@pytest.fixture
def no_msgpack(monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack as _  # noqa: F401


def test_the_fixture_is_what_jax_save_checkpoint_writes(tmp_path):
    path = save_checkpoint(str(tmp_path), _fixture_state(), 12)
    with open(path, "rb") as a, open(FIXTURE, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(FIXTURE) + os.path.getsize(FIXTURE_NPZ) <= 64 * 1024
    npz = np.load(FIXTURE_NPZ)
    want = _flatten(_fixture_state())
    assert sorted(npz.files) == sorted(want)
    for k in want:
        assert np.array_equal(npz[k], want[k]) and npz[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("blocked", [False, True], ids=["msgpack", "pure"])
def test_the_fixture_decodes_to_its_npz(request, blocked):
    if blocked:
        request.getfixturevalue("no_msgpack")
    state = ck.load_flax_msgpack(FIXTURE)
    npz = np.load(FIXTURE_NPZ)
    flat = _flatten(state)
    assert sorted(flat) == sorted(npz.files)
    for k in npz.files:
        assert flat[k].dtype == npz[k].dtype and np.array_equal(flat[k], npz[k]), k
    assert state["scheduler"]["best"] is None
    assert isinstance(state["scale"], np.ndarray) and state["scale"].shape == ()


@pytest.fixture(scope="module")
def unet_ckpt(tmp_path_factory):
    """A JAX ``save_checkpoint`` file of the selective UNet_B (float32) with
    an Adam state, as JAX ``train`` writes it."""
    model = seeded_model(31, "float32", selective=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = torch_state_dict_to_variables(sd)
    opt = optax.adam(1e-3).init(variables["params"])
    opt = optax.tree_map_params(optax.adam(1e-3), lambda p: p + 0.5, opt)
    d = str(tmp_path_factory.mktemp("jax_unet_ckpt"))
    path = save_checkpoint(d, {"net": variables, "optim": serialization.to_state_dict(opt),
                               "scheduler": {"lr": 1e-3, "last_epoch": 3}, "epoch": 3}, 3)
    return path, sd


def test_a_selective_unet_b_ckpt_decodes_alike_without_msgpack(unet_ckpt, monkeypatch):
    path, sd = unet_ckpt
    with open(path, "rb") as f:
        with_msgpack = _by_msgpack(f.read())
    port_with = ck.load_checkpoint(path)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    without = ck.load_flax_msgpack(path)
    _same_tree(without, with_msgpack)
    assert "optim" in without and without["epoch"].item() == 3
    port_without = ck.load_checkpoint(path)
    assert sorted(port_without["net"]) == sorted(port_with["net"]) == sorted(sd)
    for k, v in port_with["net"].items():
        assert torch.equal(port_without["net"][k], v), k
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    found = ck.load_latest_checkpoint(os.path.dirname(path))  # no ImportError any more
    assert found is not None and found[1] == 3


def test_snet_eval_runs_from_a_jax_ckpt_with_msgpack_blocked(unet_ckpt, tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    write_synthetic_patch_tree(data, n_slides=2, patches_per_slide=6, patch_size=SIZE, seed=2)
    argv = ["eval", "--data_dir", data, "--model_dir", os.path.dirname(unet_ckpt[0]),
            "--model_arch", "UNet_B", "--selective", "1", "--select_eval", "1",
            "--batch_size", "4", "--patch_size", str(SIZE), "--num_workers", "2",
            "--compute_dtype", "float32"]
    out = {}
    for side in ("msgpack", "blocked"):
        if side == "blocked":
            monkeypatch.setitem(sys.modules, "msgpack", None)
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(argv, device="cpu")
        out[side + "_text"] = buf.getvalue()
    assert "rejection ratio" in out["blocked_text"] and "mIoU" in out["blocked_text"]
    assert out["blocked_text"] == out["msgpack_text"]  # the confusion matrix and scores


def _subset_tree():
    """Every form flax's encoder emits for a checkpoint: ints of each width
    and sign, floats, bools, None, str and bin of each length class, maps and
    arrays of each size class, ndarray (ext 1) and numpy-scalar (ext 3)
    payloads of several dtypes, fixext and ext8/16/32 sizes."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")], "nan": float("nan"),
        "bools": [True, False], "none": None,
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é✓"],
        "map16": {f"k{i:02d}": i for i in range(20)},
        "array16": list(range(40)),
        "arrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "f16": np.ones(5, np.float16), "i8": np.arange(-3, 3, dtype=np.int8),
                   "u64": np.array([2**63], np.uint64), "bool": np.array([True, False]),
                   "empty": np.zeros((0, 4), np.float32), "f64_0d": np.array(2.5),
                   "big": np.arange(20000, dtype=np.float32)},
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-7), "u8": np.uint8(200),
                    "f64": np.float64(3.0)},
    }


def test_every_form_of_the_subset_decodes_as_msgpack_does():
    data = serialization.msgpack_serialize(_subset_tree())
    got, want = flax_msgpack.unpackb(data), _by_msgpack(data)
    _same_tree(got, want)
    assert isinstance(got["scalars"]["f32"], np.float32)  # ext 3 -> a numpy scalar
    assert len(got["array16"]) == 40 and len(got["map16"]) == 20
    restored = serialization.msgpack_restore(data)
    _same_tree(got["arrays"], restored["arrays"])


@pytest.mark.parametrize("n,header", [(6, 0xd8), (100, 0xc7), (300, 0xc8), (70000, 0xc9)],
                         ids=["fixext16", "ext8", "ext16", "ext32"])
def test_ext_of_every_size_class(n, header):
    """An int8 ndarray of ``n`` bytes packs into a fixext16, ext8, ext16 or
    ext32 (its packed (shape, dtype, bytes) is 10 + n bytes)."""
    data = serialization.msgpack_serialize({"a": np.arange(n, dtype=np.int8)})
    assert data[3] == header
    _same_tree(flax_msgpack.unpackb(data), _by_msgpack(data))


@pytest.mark.parametrize("code", [2, 0, 4, 127])
def test_unsupported_ext_types_raise_as_the_msgpack_path_does(code):
    data = msgpack.packb({"z": msgpack.ExtType(code, msgpack.packb((1.0, 2.0)))})
    for decode in (flax_msgpack.unpackb, _by_msgpack):
        with pytest.raises(ValueError, match=f"unsupported msgpack ext type {code} in checkpoint"):
            decode(data)


def test_a_complex_leaf_written_by_flax_raises():
    data = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="unsupported msgpack ext type 2"):
        flax_msgpack.unpackb(data)


def test_truncated_or_trailing_data_raises():
    data = serialization.msgpack_serialize(_subset_tree())
    for bad in (data[:-1], data[: len(data) // 2], data + b"\xc0"):
        with pytest.raises(ValueError):
            flax_msgpack.unpackb(bad)


def test_ndarray_payloads_are_views_of_the_file_bytes():
    data = serialization.msgpack_serialize({"w": np.arange(4096, dtype=np.float32)})
    arr = flax_msgpack.unpackb(data)["w"]
    assert np.shares_memory(arr, np.frombuffer(data, np.uint8))
    assert not arr.flags.writeable
