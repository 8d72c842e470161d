"""The port's ``snet-sweep`` (``tools/sweep.py``) against the JAX package's.

* ``default_grid``, ``_pick_best`` and ``_metric_scalar`` equal JAX's;
* with the same (stubbed) scores and the same checkpoint files, both
  harnesses return the same rows, write the same ``sweep_summary.csv`` and
  the same row caches (``sweep_row.json``: the same meta key);
* a tiny real sweep (1 variant x 1 fold x 2 epochs, CPU) writes the CSV with
  JAX's header and the nanmean row; a rerun is served by the row cache;
* ``--isolate_cells`` with a stubbed child (as tests/test_sweep.py:203-260),
  and one real child process (marked slow, as tests/test_sweep.py:261);
* the refusals: a fleet (ROADMAP A8), no card without a device.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.data import write_synthetic_patch_tree
from selectivenet_for_semantic_segmentation_binary_tpu.tools import sweep as jax_sweep
from selectivenet_for_semantic_segmentation_binary_torch.tools import sweep

SIZE = 32


def _as_tuple(v):
    return (v.name, v.train_kw, v.eval_kw, v.data_dir)


def test_default_grid_equals_jax():
    assert [_as_tuple(v) for v in sweep.default_grid()] == [
        _as_tuple(v) for v in jax_sweep.default_grid()]


PICKS = {
    "plain": [(0.5, "e1"), (0.7, "e2"), (0.6, "e3")],
    "nan_first": [(float("nan"), "e1"), (0.2, "e2"), (0.1, "e3")],
    "all_nan": [(float("nan"), "e1"), (float("nan"), "e2")],
    "tie": [(0.4, "e1"), (0.4, "e2")],
    "nan_last": [(0.3, "e1"), (float("nan"), "e2")],
}


@pytest.mark.parametrize("case", list(PICKS))
def test_pick_best_equals_jax(case):
    got, want = sweep._pick_best(PICKS[case]), jax_sweep._pick_best(PICKS[case])
    assert got[1] == want[1] and (got[0] == want[0] or np.isnan(got[0]) and np.isnan(want[0]))
    assert not (case != "all_nan" and np.isnan(got[0]))


@pytest.mark.parametrize("value", [0.25, [0.5, float("nan"), 1.0], np.float32(0.75)])
def test_metric_scalar_equals_jax(value):
    assert sweep._metric_scalar({"m": value}, "m") == jax_sweep._metric_scalar({"m": value}, "m")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sweep_data"))
    write_synthetic_patch_tree(d, n_slides=2, patches_per_slide=12, patch_size=SIZE, seed=21)
    return d


def _train_kw(**kw):
    base = dict(model_arch="UNet_B", selective=True, loss="BCElogit", n_epoch=2,
                batch_size=8, patch_size=SIZE, num_workers=2, compute_dtype="float32")
    base.update(kw)
    return base


def _fake_scores(cfg, ckpt, loader, device=None):
    """Scores by (split, variant, fold, epoch): nan at epoch 1, as an
    undertrained selection head gives."""
    epoch = int(os.path.basename(ckpt).split("epoch")[1].split(".")[0])
    variant = ckpt.split(os.sep)[-4]
    seed = epoch + 10 * cfg.test_fold + (100 if variant == "BC" else 0)
    seed += 1000 if cfg.select_eval else 0
    rng = np.random.default_rng(seed)
    res = {"accuracy": float(rng.random()), "accuracy_class": float(rng.random()),
           "precision": rng.random(2).tolist(), "recall": rng.random(2).tolist(),
           "f1_score": rng.random(2).tolist(),
           "mIoU": float("nan") if epoch == 1 else float(rng.random()),
           "IoU_class": [float(rng.random()), float("nan")]}
    if cfg.select_eval:
        res["rejection_ratio"] = float(rng.random())
    return res


def test_rows_csv_and_row_cache_equal_jax(data_dir, tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("port", sweep), ("jax", jax_sweep)):
        root = tmp_path / name / "models"
        for variant in ("baseline", "BC"):
            for fold in (1, 2):
                ckpt_dir = root / variant / f"{fold}-fold" / "checkpoint"
                ckpt_dir.mkdir(parents=True)
                for e in (1, 2, 3):  # made up: the cells skip training
                    (ckpt_dir / f"model_epoch{e}.ckpt").write_bytes(b"")
        monkeypatch.setattr(mod, "_eval_single_checkpoint", _fake_scores)
        kw = dict(folds=[1, 2], variants=[mod.Variant("baseline"), mod.Variant(
            "BC", train_kw={"blankfield": True}, eval_kw={"blankfield": True})],
            train_overrides=_train_kw(n_epoch=3), eval_overrides={"select_eval": True},
            select_overrides={"select_eval": False}, save_dir=str(tmp_path / name / "out"),
            verbose=False)
        if mod is sweep:
            kw["device"] = "cpu"
        rows = mod.run_sweep(data_dir, str(root), **kw)
        with open(tmp_path / name / "out" / "sweep_summary.csv") as f:
            csv = f.read()
        caches = {}
        for variant in ("baseline", "BC"):
            for fold in (1, 2):
                with open(root / variant / f"{fold}-fold" / "sweep_row.json") as f:
                    caches[variant, fold] = json.load(f)
        outs[name] = (rows, csv, caches)
    (prow, pcsv, pcache), (jrow, jcsv, jcache) = outs["port"], outs["jax"]
    assert json.dumps(prow) == json.dumps(jrow)
    assert pcsv == jcsv
    for key in jcache:  # the meta key names the data_dir, shared by both
        assert pcache[key] == jcache[key], key
    assert [r["fold"] for r in prow] == [1, 2, "mean", 1, 2, "mean"]
    assert all(r["best_epoch"] in (2, 3) for r in prow if r["fold"] != "mean")


@pytest.fixture(scope="module")
def real_sweep(data_dir, tmp_path_factory):
    """One variant, one fold, two epochs, trained and scored on the CPU."""
    root = str(tmp_path_factory.mktemp("sweep_models"))
    out = str(tmp_path_factory.mktemp("sweep_out"))
    kw = dict(folds=[1], variants=[sweep.Variant("baseline")], train_overrides=_train_kw(),
              eval_overrides={"select_eval": True}, select_overrides={"select_eval": False},
              save_dir=out, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        rows = sweep.run_sweep(data_dir, root, **kw)
    return root, out, kw, rows


def test_real_sweep_writes_jaxs_csv(real_sweep):
    root, out, _, rows = real_sweep
    with open(os.path.join(out, "sweep_summary.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == ("variant,fold,best_epoch,accuracy,accuracy_class,precision,recall,"
                        "f1_score,mIoU,IoU_class,rejection_ratio")
    assert lines[1].startswith("baseline,1,") and lines[2].startswith("baseline,mean,,")
    row, mean = rows
    assert row["best_epoch"] in (1, 2) and 0.0 <= row["mIoU"] <= 1.0
    assert 0.0 <= row["rejection_ratio"] <= 1.0 and "valid_mIoU" in row
    for key in ("accuracy", "mIoU", "rejection_ratio"):
        assert mean[key] == row[key]
    assert sorted(os.listdir(os.path.join(root, "baseline", "1-fold", "checkpoint"))) == [
        "model_epoch1.pth", "model_epoch2.pth"]
    # the cell's TensorBoard scalars are read back by the port's reader
    from selectivenet_for_semantic_segmentation_binary_torch.utils.tb_reader import (
        read_scalars)

    log = os.path.join(root, "baseline", "1-fold", "log")
    assert [s for s, _ in read_scalars(os.path.join(log, "train"))["loss"]] == [1, 2]
    assert [s for s, _ in read_scalars(os.path.join(log, "valid"))["loss"]] == [1, 2]


def test_row_cache_skips_rescoring(real_sweep, data_dir, monkeypatch):
    root, _, kw, rows = real_sweep
    calls = []
    monkeypatch.setattr(sweep, "_eval_single_checkpoint",
                        lambda *a, **k: calls.append(1) or _fake_scores(*a, **k))
    kw = {**kw, "save_dir": None, "verbose": False}
    again = sweep.run_sweep(data_dir, root, **kw)
    assert not calls and json.dumps(again) == json.dumps(rows)
    sweep.run_sweep(data_dir, root, **{**kw, "select_metric": "accuracy"})
    assert len(calls) == 3  # a changed key rescored: 2 epochs + the winner


class TestIsolateCells:
    """--isolate_cells with a stubbed child, as tests/test_sweep.py does."""

    def _grid_kw(self):
        return dict(folds=[1], variants=[sweep.Variant("baseline")],
                    train_overrides=_train_kw(selective=False), eval_overrides={},
                    verbose=False, device="cpu")

    def test_retry_then_success_and_spec_roundtrip(self, data_dir, tmp_path, monkeypatch):
        model_root = str(tmp_path / "models")
        ckpt_dir = os.path.join(model_root, "baseline", "1-fold", "checkpoint")
        os.makedirs(ckpt_dir)
        for e in (1, 2):  # made-up checkpoints: the cell skips training
            open(os.path.join(ckpt_dir, f"model_epoch{e}.pth"), "wb").close()

        def fake_eval(cfg, ckpt, loader, device=None):
            assert str(device) == "cpu"
            return {"accuracy": 0.9, "accuracy_class": 0.9, "precision": [0.9],
                    "recall": [0.9], "f1_score": [0.9], "mIoU": 0.875, "IoU_class": [0.9]}

        monkeypatch.setattr(sweep, "_eval_single_checkpoint", fake_eval)
        attempts = []

        def fake_spawn(cmd):
            attempts.append(list(cmd))
            if len(attempts) == 1:
                return 137  # a child killed before it wrote its row
            spec = cmd[cmd.index("--cell_spec") + 1]
            with open(spec) as f:
                assert json.load(f)["device"] == "cpu"
            sweep.main(["--cell_spec", spec])  # the child's entry, in process
            return 0

        monkeypatch.setattr(sweep, "_spawn_cell", fake_spawn)
        rows = sweep.run_sweep(data_dir, model_root, isolate_cells=True, cell_retries=2,
                               cell_retry_delay=0.01, **self._grid_kw())
        assert len(attempts) == 2
        assert attempts[0][1:3] == ["-m", "selectivenet_for_semantic_segmentation_binary_torch"
                                          ".tools.sweep"]
        assert rows[0]["mIoU"] == pytest.approx(0.875) and rows[1]["fold"] == "mean"
        assert os.path.exists(os.path.join(model_root, "baseline", "1-fold", "sweep_row.json"))

    def test_exhausted_retries_raise(self, data_dir, tmp_path, monkeypatch):
        monkeypatch.setattr(sweep, "_spawn_cell", lambda cmd: 137)
        with pytest.raises(RuntimeError, match="no result row"):
            sweep.run_sweep(data_dir, str(tmp_path / "models"), isolate_cells=True,
                            cell_retries=1, cell_retry_delay=0.01, **self._grid_kw())

    @pytest.mark.slow
    def test_true_subprocess_end_to_end(self, data_dir, tmp_path, monkeypatch):
        """One real child interpreter, started from another working
        directory, trains and scores a tiny cell on the CPU; a rerun is a
        pure cache hit."""
        monkeypatch.chdir(tmp_path)
        model_root = str(tmp_path / "models")
        kw = dict(self._grid_kw(), train_overrides=_train_kw(selective=False, n_epoch=1),
                  isolate_cells=True, cell_retries=0)
        rows = sweep.run_sweep(data_dir, model_root, **kw)
        assert rows[0]["best_epoch"] == 1 and 0.0 <= rows[0]["mIoU"] <= 1.0
        assert os.path.exists(os.path.join(model_root, "baseline", "1-fold", "checkpoint",
                                           "model_epoch1.pth"))
        monkeypatch.setattr(sweep, "_spawn_cell",
                            lambda cmd: (_ for _ in ()).throw(AssertionError("spawned")))
        assert sweep.run_sweep(data_dir, model_root, **kw)[0] == rows[0]


def test_a_fleet_is_refused(data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        sweep.run_sweep(data_dir, str(tmp_path), folds=[1], device="cpu")


def test_no_device_and_no_card_raises(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sweep.run_sweep(data_dir, str(tmp_path), folds=[1])
    assert os.listdir(tmp_path) == []


def test_cli_refuses_an_unknown_variant(tmp_path, capsys):
    with pytest.raises(SystemExit):
        sweep.main(["--data_dir", str(tmp_path), "--model_root", str(tmp_path),
                    "--variants", "NT"], device="cpu")
    assert "unknown variants ['NT']" in capsys.readouterr().err
