"""CPU tests of the benchmark's harness: the frozen counts, the files found by
name, the whole-name check of what the harness and the reference import."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from snetbench import core, counts

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def test_forward_flops_of_unet_b_at_256():
    assert counts.forward_flops(256) == pytest.approx(73.5e9, rel=1e-3)
    assert counts.train_step_flops(128) == pytest.approx(28.24e12, rel=1e-3)


def test_forward_flops_match_the_ports_layer_count():
    """The frozen table against the port's own per-layer MACs
    (``tools/synthetic.conv_macs``), at a smaller side that scales exactly."""
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        conv_macs, seeded_model)

    rows = conv_macs(seeded_model(0, "float32"), 64, 64)
    assert 2.0 * sum(m for _, _, m in rows) == pytest.approx(counts.forward_flops(64), rel=1e-9)


def test_int8_bounds():
    assert counts.int8_conv_bound_ms(128) == pytest.approx(5.976, abs=5e-4)
    assert 2.0 * counts.conv3x3_macs() * 128 == pytest.approx(9.00e12, rel=1e-3)
    assert counts.int8_forward_least_ms(128) == pytest.approx(4.97, abs=0.01)


@pytest.mark.parametrize("name,kind", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "cudnn_cublas_conv_matmul"),
    ("void int8_conv_wgmma_kernel<true>", "int8_conv"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::batch_norm_collect_statistics_kernel", "batch_norm"),
    ("something_new", "other"),
])
def test_kernel_kinds(name, kind):
    assert counts.kind_of(name) == kind


def test_benchmark_file_names_files_that_exist():
    bench = core.benchmark_file()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(HERE, "limits", f"{w['name']}.json"))
        kind = core.traffic(w["traffic"])["kind"]
        assert os.path.exists(os.path.join(HERE, "snetbench", "drivers", f"{kind}.py"))
        e2e, layer = core.cell_metrics(bench, w["name"])
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer
        reported = {m["name"] for m in e2e}
        assert all(m["moves"] in reported for m in layer)
    for m in bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]))


def _digest(path):
    out = {}
    for base, _, files in os.walk(path):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_is_found_by_name_without_editing_a_file(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a per-layer metric and a cell added as
    new files and entries only: the harness finds each by its name."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digest(bench_dir)
    (bench_dir / "configs" / "unet_b_new.json").write_text(json.dumps(
        {**core.config("unet_b_sel_bf16"), "name": "unet_b_new"}))
    (bench_dir / "traffic" / "infer_b64.json").write_text(json.dumps(
        {**core.traffic("infer_b128"), "batch": 64}))
    (bench_dir / "metrics" / "calls_per_s.infer.py").write_text(textwrap.dedent('''
        def read(r):
            return r.batches / r.window_s if r.window_s else None
    '''))
    (bench_dir / "limits" / "infer.unet_b_new.b64.json").write_text(
        json.dumps({"limits": {"prob_gap_max": 0.5}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "infer.unet_b_new.b64", "config": "unet_b_new",
                               "traffic": "infer_b64", "chips": 1, "why": "a test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index(
        "infer_patches_per_s")]["workloads"].append("infer.unet_b_new.b64")
    bench["per_layer"].append({"name": "calls_per_s.infer", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "Device",
                               "moves": "infer_patches_per_s",
                               "workloads": ["infer.unet_b_new.b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(bench_dir)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    monkeypatch.setattr(core, "HERE", str(bench_dir))
    monkeypatch.setattr(core, "ROOT", str(tmp_path))
    b = core.benchmark_file()
    wl = core.workload(b, "infer.unet_b_new.b64")
    assert core.config(wl["config"])["name"] == "unet_b_new"
    assert core.traffic(wl["traffic"])["batch"] == 64
    assert core.limits(wl["name"]) == {"prob_gap_max": 0.5}
    e2e, layer = core.cell_metrics(b, wl["name"])
    assert [m["name"] for m in e2e] == ["setup_s", "infer_patches_per_s"]
    assert [m["name"] for m in layer] == ["calls_per_s.infer"]
    r = core.Readings(window_s=2.0, chips=1, batches=10)
    assert core.metric_reader("calls_per_s.infer")(r) == 5.0


def _loaded(code: str):
    """Top-level names of every module loaded in a fresh interpreter after
    ``code``."""
    script = ("import sys\nsys.path[:0] = [%r, %r]\n%s\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))" % (HERE, ROOT, code))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_harness_and_reference_load_no_jax_by_whole_name():
    """Every harness module, every driver, every metric reader, and a whole
    small CPU run of each kind of traffic (which imports the port): no module
    whose top-level name is jax, jaxlib, flax or the JAX package. The port's
    name begins with the JAX package's stem, so names are compared whole."""
    code = textwrap.dedent('''
        import glob, importlib, os
        from snetbench import core
        import reference.unet_b
        for p in glob.glob(os.path.join(core.HERE, "snetbench", "**", "*.py"), recursive=True):
            rel = os.path.relpath(p, core.HERE)[:-3].replace(os.sep, ".")
            importlib.import_module(rel[:-9] if rel.endswith("__init__") else rel)
        for p in glob.glob(os.path.join(core.HERE, "metrics", "*.py")):
            core.metric_reader(os.path.basename(p)[:-3])
        import test_snetbench_runs as t
        t.small_run("train.unet_b.b128", seconds=0.2)
        t.small_run("infer.unet_b_int8.b128", seconds=0.2)
    ''')
    names = _loaded(code)
    assert core.PORT in names  # the runs did import the port
    assert not names & set(core.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    names = _loaded("import reference.unet_b")
    assert not names & ({core.PORT} | set(core.FORBIDDEN))


def test_judge_needs_every_number_under_its_limit():
    assert core.judge({"a": 1.0}, {"a": 1.0})[0]
    assert not core.judge({"a": 1.1}, {"a": 1.0})[0]
    assert not core.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not core.judge({"a": 0.5}, {"a": 1.0, "b": 1.0})[0]  # a number never read
    assert core.judge({"a": 0.5, "c": 9.0}, {"a": 1.0})[0]  # only the limited are compared
