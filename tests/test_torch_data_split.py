"""The port's ``snet-split`` (``tools/data_split.py``) and its hard synthetic
tree writer (``tools/synthetic.write_hard_synthetic_patch_tree``) against
the JAX package's, exactly: the KFold test folds (the JAX one calls
scikit-learn, the port has its own), the fold ``.npy`` files, the mined
non-tissue patches, the pixel report, the proportion histogram, the CLI's
lines, and the hard tree's files byte for byte."""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.data.dataset import (
    write_hard_synthetic_patch_tree as jax_write_hard, write_synthetic_patch_tree)
from selectivenet_for_semantic_segmentation_binary_tpu.tools import data_split as jax_split
from selectivenet_for_semantic_segmentation_binary_torch.tools import data_split
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
    write_hard_synthetic_patch_tree)

SIZE = 32


@pytest.mark.parametrize("n", [0, 3, 5, 7, 13, 101])
@pytest.mark.parametrize("seed", [0, 44])
def test_kfold_indices_equal_jax(n, seed):
    got = data_split._kfold_indices(n, 5, seed)
    want = jax_split._kfold_indices(n, 5, seed)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A synthetic tree plus near-white background patches and an unpaired
    input, at two patch sizes."""
    d = str(tmp_path_factory.mktemp("split_data"))
    write_synthetic_patch_tree(d, n_slides=3, patches_per_slide=9, patch_size=SIZE, seed=4)
    write_synthetic_patch_tree(d, n_slides=1, patches_per_slide=4, patch_size=2 * SIZE, seed=5)
    patch_dir = os.path.join(d, f"200x_{SIZE}")
    rng = np.random.default_rng(6)
    for i in range(3):
        white = (248 + rng.integers(0, 8, (SIZE, SIZE, 3))).astype(np.uint8)
        Image.fromarray(white).save(os.path.join(patch_dir, f"bg{i}_0_0_input.jpg"))
        Image.fromarray(np.zeros((SIZE, SIZE), np.uint8)).save(
            os.path.join(patch_dir, f"bg{i}_0_0_label.png"))
    Image.fromarray(np.full((SIZE, SIZE, 3), 128, np.uint8)).save(
        os.path.join(patch_dir, "lonely_0_0_input.jpg"))
    return d


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files, cmp.report()
    for name in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_build_fold_lists_equals_jax(data_dir, tmp_path):
    got = data_split.build_fold_lists(data_dir, patch_size=SIZE, out_dir=str(tmp_path / "p"))
    want = jax_split.build_fold_lists(data_dir, patch_size=SIZE, out_dir=str(tmp_path / "j"))
    assert got == want and got["tumorable"] > 5 and got["non_tumorable"] > 5
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    for name in os.listdir(tmp_path / "p"):
        a, b = np.load(tmp_path / "p" / name), np.load(tmp_path / "j" / name)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_fold_lists_refuses_an_empty_tree(tmp_path):
    for split in (data_split, jax_split):
        with pytest.raises(FileNotFoundError, match="no .*pairs"):
            os.makedirs(tmp_path / "200x_256", exist_ok=True)
            split.build_fold_lists(str(tmp_path))


def test_mine_non_tissue_equals_jax(data_dir, tmp_path):
    got = data_split.mine_non_tissue(data_dir, str(tmp_path / "p"), patch_size=SIZE)
    want = jax_split.mine_non_tissue(data_dir, str(tmp_path / "j"), patch_size=SIZE)
    assert got == want == 3
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))


def test_report_and_histogram_equal_jax(data_dir, tmp_path):
    jax_split.build_fold_lists(data_dir, patch_size=SIZE)  # the lists both read
    got = data_split.tumor_pixel_report(data_dir, patch_size=SIZE)
    want = jax_split.tumor_pixel_report(data_dir, patch_size=SIZE)
    assert got == want and sorted(got) == [1, 2, 3, 4, 5]
    got = data_split.tumor_proportion_histogram(data_dir, patch_sizes=(SIZE, 2 * SIZE, 512))
    want = jax_split.tumor_proportion_histogram(data_dir, patch_sizes=(SIZE, 2 * SIZE, 512))
    assert got == want and sorted(got) == [SIZE, 2 * SIZE]


def test_cli_prints_the_same_lines(data_dir, tmp_path):
    outs = []
    for split in (data_split, jax_split):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            split.main(["--data_dir", data_dir, "--patch_size", str(SIZE), "--report",
                        "--proportion_hist", "--hist_sizes", str(SIZE), str(2 * SIZE)])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "fold 5: tumor_ratio=" in outs[0]


@pytest.mark.parametrize("kw", [
    {}, {"ambiguous_level": 0.3, "camo_level": 0.0, "seed": 9, "n_folds": 3},
], ids=["defaults", "levels"])
def test_hard_synthetic_tree_is_byte_identical(kw, tmp_path):
    args = dict(n_slides=2, patches_per_slide=3, patch_size=SIZE, **kw)
    write_hard_synthetic_patch_tree(str(tmp_path / "p"), **args)
    jax_write_hard(str(tmp_path / "j"), **args)
    _same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    _same_tree(str(tmp_path / "p" / f"200x_{SIZE}"), str(tmp_path / "j" / f"200x_{SIZE}"))
    assert len(os.listdir(tmp_path / "p" / f"200x_{SIZE}")) == 12


def test_hard_tree_fold_lists_rebuild_the_writers_classes(tmp_path):
    """data_split's classes are the writer's (the same 10% rule on the same
    labels); the folds themselves differ by design: the writer deals
    round-robin, data_split shuffles with KFold(seed 44)."""
    d = str(tmp_path)
    write_hard_synthetic_patch_tree(d, n_slides=2, patches_per_slide=6, patch_size=SIZE, seed=2)
    data_split.build_fold_lists(d, patch_size=SIZE, out_dir=os.path.join(d, "rebuilt"))
    for cls in ("tumorable", "non_tumorable"):
        writer = [np.load(os.path.join(d, f"{i}-fold_{cls}_data.npy")) for i in range(1, 6)]
        rebuilt = [np.load(os.path.join(d, "rebuilt", f"{i}-fold_{cls}_data.npy"))
                   for i in range(1, 6)]
        assert sorted(map(tuple, np.concatenate(writer).tolist())) == sorted(
            map(tuple, np.concatenate(rebuilt).tolist()))
        assert [len(a) for a in writer] == [len(a) for a in rebuilt]
