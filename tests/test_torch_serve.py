"""The port's ``snet-serve`` (``tools/serve.py``): the micro-batching
``PredictionService`` and its HTTP server, on the CPU.

The HTTP surface is driven end to end with a seeded checkpoint, and its
JSON summary is held to the JAX package's server on the same checkpoint and
image; the batcher's grouping, occupancy buckets, backpressure and error
delivery are pinned with a fake predictor whose forward time is set.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from selectivenet_for_semantic_segmentation_binary_tpu.predictor import (
    Predictor as JaxPredictor)
from selectivenet_for_semantic_segmentation_binary_tpu.tools import serve as jax_serve
from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
from selectivenet_for_semantic_segmentation_binary_torch.tools import serve
from selectivenet_for_semantic_segmentation_binary_torch.tools.predict import _pad_to_grid
from selectivenet_for_semantic_segmentation_binary_torch.tools.serve import (
    PredictionService, ServerBusyError, _bucket, make_server)
from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import seeded_model

NEAR = 1e-5


def _png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _request(url, method="GET", data=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


class _Running:
    """A server on a free port, served from a thread; stopped on exit."""

    def __init__(self, service, **kw):
        self.service = service
        self.server = make_server(service, "127.0.0.1", 0, **kw)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_serve_ckpt") / "model_epoch1.pth")
    torch.save({"net": seeded_model(31, "float32", selective=True).state_dict()}, path)
    return path


@pytest.fixture(scope="module")
def image_arr():
    return np.random.default_rng(32).integers(0, 256, (36, 44, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def served(ckpt):
    predictor = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu")
    service = PredictionService(predictor, max_batch=4, batch_window_ms=10.0,
                                request_timeout_s=300.0)
    with _Running(service, model_info={"model_arch": "UNet_B", "selective": True}) as run:
        yield run.url, service, predictor


def _direct(predictor, image_arr):
    padded, h, w = _pad_to_grid(image_arr)
    return {k: v[0, :h, :w] for k, v in predictor.predict(padded[None]).items()}


def test_buckets_are_the_jax_buckets():
    for cap in (1, 2, 3, 4, 8, 16):
        for n in range(1, 20):
            assert _bucket(n, cap) == jax_serve._bucket(n, cap)
    assert [_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]


def test_healthz_info_and_unknown_paths(served):
    url, _, _ = served
    code, body, ctype = _request(url + "/healthz")
    assert code == 200 and ctype == "application/json"
    payload = json.loads(body)
    assert payload["status"] == "ok" and payload["backend"] == "cpu"
    assert payload["quantize"] == "none"  # the port's /healthz also names the trunk
    code, body, _ = _request(url + "/info")
    info = json.loads(body)
    assert info["model"]["selective"] is True and info["model"]["max_batch"] == 4
    assert set(info["stats"]) >= {"n_requests", "n_batches", "mean_occupancy", "shapes_seen"}
    assert _request(url + "/nope")[0] == 404
    assert _request(url + "/nope", method="POST", data=b"x")[0] == 404


def test_json_summary_matches_the_jax_server(served, ckpt, image_arr):
    url, _, predictor = served
    code, body, _ = _request(url + "/predict", method="POST", data=_png_bytes(image_arr))
    assert code == 200
    got = json.loads(body)
    jax_pred = JaxPredictor(ckpt, selective=True, compute_dtype="float32")
    jax_service = jax_serve.PredictionService(jax_pred, max_batch=1)
    jax_server = jax_serve.make_server(jax_service, "127.0.0.1", 0)
    threading.Thread(target=jax_server.serve_forever, daemon=True).start()
    try:
        code, body, _ = _request(f"http://127.0.0.1:{jax_server.server_address[1]}/predict",
                                 method="POST", data=_png_bytes(image_arr))
    finally:
        jax_server.shutdown()
        jax_server.server_close()
        jax_service.close()
    assert code == 200
    want = json.loads(body)
    assert set(got) == set(want) == {"shape", "tumor_fraction", "coverage"}
    assert got["shape"] == want["shape"] == [36, 44]
    # a pixel within NEAR of a cut-off may flip: that many pixels are the allowance
    padded, h, w = _pad_to_grid(image_arr)
    ref = {k: v[0, :h, :w] for k, v in jax_pred.predict(padded[None]).items()}
    for key, prob in (("tumor_fraction", "prob"), ("coverage", "selection_prob")):
        allowance = int((np.abs(ref[prob] - 0.5) < NEAR).sum())
        assert abs(got[key] - want[key]) * h * w <= allowance + 1e-9, key
        assert 0 < got[key] < 1
    direct = _direct(predictor, image_arr)
    assert got["tumor_fraction"] == pytest.approx(float(direct["pred"].mean()), abs=1e-12)


def test_png_and_npz_responses(served, image_arr):
    url, _, predictor = served
    direct = _direct(predictor, image_arr)
    for output in ("pred", "selection"):
        code, body, ctype = _request(url + f"/predict?format=png&output={output}",
                                     method="POST", data=_png_bytes(image_arr))
        assert code == 200 and ctype == "image/png"
        mask = np.asarray(Image.open(io.BytesIO(body)))
        assert np.array_equal(mask, direct[output] * 255)
    code, body, ctype = _request(url + "/predict?format=npz", method="POST",
                                 data=_png_bytes(image_arr))
    assert code == 200 and ctype == "application/octet-stream"
    maps = np.load(io.BytesIO(body))
    assert set(maps.files) == {"prob", "pred", "selection_prob", "selection"}
    for k in maps.files:
        assert maps[k].shape == (36, 44)
        np.testing.assert_array_equal(maps[k], direct[k])
    assert maps["prob"].dtype == np.float32


def test_bad_requests(served):
    url, _, _ = served
    code, body, _ = _request(url + "/predict", method="POST", data=b"not an image")
    assert code == 400 and b"could not decode" in body
    assert _request(url + "/predict", method="POST", data=b"")[0] == 400
    assert _request(url + "/predict?format=bmp", method="POST", data=b"x")[0] == 400
    assert _request(url + "/predict?output=prob", method="POST", data=b"x")[0] == 400


def test_metrics_counters_agree_with_info(served, image_arr):
    url, service, _ = served
    before = service.stats.n_requests
    assert _request(url + "/predict", "POST", _png_bytes(image_arr))[0] == 200
    code, body, ctype = _request(url + "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    text = body.decode()
    metrics = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            k, v = line.split()
            metrics[k] = float(v)
    info = json.loads(_request(url + "/info")[1])["stats"]
    assert info["n_requests"] == before + 1
    assert metrics["snet_requests_total"] == info["n_requests"]
    assert metrics["snet_batches_total"] == info["n_batches"]
    assert metrics["snet_errors_total"] == info["n_errors"]
    assert metrics["snet_rejected_total"] == info["n_rejected"]
    assert metrics["snet_batch_occupancy_sum"] == info["mean_occupancy"] * info["n_batches"]
    assert metrics["snet_pending_requests"] == 0 and metrics["snet_uptime_seconds"] > 0
    assert [40, 48] in info["shapes_seen"]
    for name in metrics:
        assert f"# TYPE {name} " in text


def test_non_selective_server(tmp_path, image_arr):
    path = str(tmp_path / "model_epoch1.pth")
    torch.save({"net": seeded_model(33, "float32", selective=False).state_dict()}, path)
    predictor = Predictor(path, selective=False, compute_dtype="float32", device="cpu")
    with _Running(PredictionService(predictor, max_batch=1)) as run:
        code, body, _ = _request(run.url + "/predict", method="POST", data=_png_bytes(image_arr))
        assert code == 200 and "coverage" not in json.loads(body)
        code, body, _ = _request(run.url + "/predict?format=png&output=selection",
                                 method="POST", data=_png_bytes(image_arr))
        assert code == 400 and b"selective checkpoint" in body


# -- the compact service -------------------------------------------------------

def test_compact_service_matches_full_precision(served, image_arr):
    _, _, predictor = served
    compact = PredictionService(predictor, max_batch=4, batch_window_ms=10.0,
                                compact_output=True)
    try:
        direct = _direct(predictor, image_arr)
        res = compact.predict_one(image_arr)
        assert set(res) == {"prob", "pred", "selection_prob", "selection"}
        assert res["prob"].dtype == np.float32
        np.testing.assert_array_equal(res["pred"], direct["pred"])
        np.testing.assert_array_equal(res["selection"], direct["selection"])
        assert np.abs(res["prob"] - direct["prob"]).max() <= 0.5 / 255.0 + 1e-6
        masks = compact.predict_one(image_arr, want_prob=False)
        assert set(masks) == {"pred", "selection"}
        np.testing.assert_array_equal(masks["pred"], direct["pred"])
    finally:
        compact.close()
    # a full-precision service ignores the hint: prob always ships
    res = served[1].predict_one(image_arr, want_prob=False)
    assert "prob" in res and "selection_prob" in res


def test_compact_http_json_rides_masks_only(served, image_arr):
    _, _, predictor = served
    service = PredictionService(predictor, max_batch=2, batch_window_ms=5.0,
                                compact_output=True)
    with _Running(service, model_info={"compact_output": True}) as run:
        code, body, _ = _request(run.url + "/predict?format=json", method="POST",
                                 data=_png_bytes(image_arr))
        assert code == 200
        summary = json.loads(body)
        code, body, _ = _request(run.url + "/predict?format=npz", method="POST",
                                 data=_png_bytes(image_arr))
        assert code == 200
        maps = np.load(io.BytesIO(body))
    assert summary["tumor_fraction"] == pytest.approx(float(maps["pred"].mean()))
    assert summary["coverage"] == pytest.approx(float(maps["selection"].mean()))
    direct = _direct(predictor, image_arr)
    np.testing.assert_array_equal(maps["pred"], direct["pred"])
    assert np.abs(maps["prob"] - direct["prob"]).max() <= 0.5 / 255.0 + 1e-6


# -- the batcher, with a fake predictor ----------------------------------------

class _FakePredictor:
    """Deterministic stand-in with a set forward time: records each batch's
    shape and, for predict_compact, its want_prob."""

    device = torch.device("cpu")

    def __init__(self, forward_s: float = 0.0, fail: bool = False):
        self.forward_s = forward_s
        self.fail = fail
        self.batches = []
        self.want_prob = []

    def predict(self, batch):
        self.batches.append(batch.shape)
        if self.fail:
            raise RuntimeError("synthetic forward failure")
        time.sleep(self.forward_s)
        n, h, w = batch.shape[:3]
        return {"prob": np.full((n, h, w), 0.75, np.float32),
                "pred": np.ones((n, h, w), np.uint8)}

    def predict_compact(self, batch, want_prob=True):
        self.want_prob.append(want_prob)
        out = self.predict(batch)
        res = {"pred": out["pred"]}
        if want_prob:
            res["prob_u8"] = np.full(out["pred"].shape, 191, np.uint8)
        return res


def _call_later(service, results, name, img, **kw):
    t = threading.Thread(target=lambda: results.__setitem__(name, service.predict_one(img, **kw)))
    t.start()
    return t


def _join(threads):
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def test_concurrent_requests_share_a_forward():
    # window 50 ms, forward 300 ms: request 0 runs alone; 1-3 queue while
    # the worker is inside its forward and form one group after it
    fake = _FakePredictor(forward_s=0.3)
    service = PredictionService(fake, max_batch=4, batch_window_ms=50.0)
    try:
        img = np.zeros((16, 16, 3), np.float32)
        results = {}
        threads = [_call_later(service, results, 0, img)]
        time.sleep(0.2)
        threads += [_call_later(service, results, i, img) for i in (1, 2, 3)]
        _join(threads)
        assert all(results[i]["prob"].shape == (16, 16) for i in range(4))
        assert service.stats.n_batches == 2
        assert fake.batches == [(1, 16, 16, 3), (4, 16, 16, 3)]
        assert service.stats.occupancy_sum == 4 and service.stats.padded_sum == 5
    finally:
        service.close()


@pytest.mark.parametrize("other", ["shape", "dtype"])
def test_mixed_groups_are_split_not_dropped(other):
    # warm's window expires before s1, o1, s2 arrive; they queue in order
    # while the worker is inside warm's forward and group as [s1, s2], the
    # mismatched o1 going to the front of the next batch
    fake = _FakePredictor(forward_s=0.3)
    service = PredictionService(fake, max_batch=4, batch_window_ms=50.0)
    try:
        small = np.zeros((16, 16, 3), np.float32)
        odd = (np.zeros((24, 24, 3), np.float32) if other == "shape"
               else np.zeros((16, 16, 3), np.uint8))
        results = {}
        threads = [_call_later(service, results, "warm", small)]
        time.sleep(0.15)
        for name, img in (("s1", small), ("o1", odd), ("s2", small)):
            threads.append(_call_later(service, results, name, img))
            time.sleep(0.03)
        _join(threads)
        assert set(results) == {"warm", "s1", "o1", "s2"}
        assert results["o1"]["prob"].shape == odd.shape[:2]
        assert [s[0] for s in fake.batches] == [1, 2, 1]  # warm; s1 + s2; o1
    finally:
        service.close()


def test_mixed_compact_group_upgrades_to_the_prob_graph():
    fake = _FakePredictor(forward_s=0.3)
    service = PredictionService(fake, max_batch=4, batch_window_ms=50.0, compact_output=True)
    try:
        img = np.zeros((16, 16, 3), np.uint8)
        results = {}
        threads = [_call_later(service, results, "warm", img, want_prob=False)]
        time.sleep(0.15)
        threads += [_call_later(service, results, "masks", img, want_prob=False),
                    _call_later(service, results, "prob", img, want_prob=True)]
        _join(threads)
        assert fake.want_prob == [False, True]
        assert set(results["warm"]) == {"pred"}
        # the mixed group ran the prob graph, and both requests got the superset
        assert set(results["masks"]) == set(results["prob"]) == {"pred", "prob"}
        assert results["prob"]["prob"][0, 0] == np.float32(191) / 255.0
    finally:
        service.close()


def test_forward_error_is_delivered_and_the_worker_survives():
    fake = _FakePredictor(fail=True)
    service = PredictionService(fake, max_batch=2, batch_window_ms=1.0)
    try:
        img = np.zeros((16, 16, 3), np.float32)
        with pytest.raises(RuntimeError, match="synthetic forward"):
            service.predict_one(img)
        assert service.stats.n_errors == 1
        fake.fail = False
        assert service.predict_one(img)["pred"].shape == (16, 16)
    finally:
        service.close()


def test_warmup_runs_every_bucket_of_both_graphs():
    fake = _FakePredictor()
    service = PredictionService(fake, max_batch=4, compact_output=True)
    try:
        service.warmup(16, 16, 3, dtype=np.uint8)
        assert sorted(s[0] for s in fake.batches) == [1, 1, 2, 2, 4, 4]
        assert sorted(fake.want_prob) == [False] * 3 + [True] * 3
    finally:
        service.close()


def test_bad_construction_is_refused():
    with pytest.raises(ValueError, match="max_batch"):
        PredictionService(_FakePredictor(), max_batch=0)
    with pytest.raises(ValueError, match="max_queue"):
        PredictionService(_FakePredictor(), max_queue=-1)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        PredictionService(_FakePredictor(), mesh=object())


def test_max_queue_rejects_and_releases():
    fake = _FakePredictor(forward_s=0.5)
    service = PredictionService(fake, max_batch=2, batch_window_ms=1.0, max_queue=1)
    try:
        img = np.zeros((16, 16, 3), np.float32)
        results = {}
        t = _call_later(service, results, "a", img)
        time.sleep(0.15)  # a is inside the forward: pending 1
        with pytest.raises(ServerBusyError, match="max_queue=1"):
            service.predict_one(img)
        assert service.stats.n_rejected == 1
        _join([t])
        assert service.predict_one(img)["prob"].shape == (16, 16)  # capacity freed
        # a request that fails before it is queued releases its slot
        for _ in range(3):
            with pytest.raises(ValueError):
                service.predict_one([["not-an-image"]])
        with service._stats_lock:
            assert service._pending == 0
        assert service.stats.n_rejected == 1
    finally:
        service.close()


def test_http_503_with_retry_after(image_arr):
    fake = _FakePredictor(forward_s=1.0)
    service = PredictionService(fake, max_batch=2, batch_window_ms=1.0, max_queue=1)
    with _Running(service) as run:
        body = _png_bytes(image_arr)
        first = {}
        t = threading.Thread(target=lambda: first.update(
            resp=_request(f"{run.url}/predict", "POST", body)))
        t.start()
        time.sleep(0.4)  # the first request is inside the slow forward
        req = urllib.request.Request(f"{run.url}/predict", data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503 and ei.value.headers.get("Retry-After") == "1"
        assert b"max_queue" in ei.value.read()
        _join([t])
        assert first["resp"][0] == 200
        metrics = _request(f"{run.url}/metrics")[1].decode()
        assert "snet_rejected_total 1" in metrics


def test_shutdown_completes_an_inflight_request(image_arr):
    fake = _FakePredictor(forward_s=0.5)
    service = PredictionService(fake, max_batch=2, batch_window_ms=1.0)
    server = make_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    result = {}
    t = threading.Thread(target=lambda: result.update(
        resp=_request(f"{url}/predict", "POST", _png_bytes(image_arr))))
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        with service._stats_lock:
            if service._pending >= 1:
                break
        time.sleep(0.02)
    else:
        pytest.fail("the request never reached the service")
    server.shutdown()
    server.server_close()  # joins the in-flight handler thread
    service.close()
    _join([t])
    assert result["resp"][0] == 200


def test_sigterm_drains_and_exits_zero(ckpt):
    code = ("from selectivenet_for_semantic_segmentation_binary_torch.tools.serve import main\n"
            f"main(['--model_path', {ckpt!r}, '--selective', '1', '--port', '0', "
            "'--compute_dtype', 'float32', '--warmup', '16', '16', '--max_batch', '2'], "
            "device='cpu')")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, env=env, text=True)
    lines = []
    started = threading.Event()

    def read():
        for line in p.stdout:
            lines.append(line)
            if "serving UNet_B" in line:
                started.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert started.wait(120), f"the server never started: {lines}"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
        reader.join(timeout=10)
        out = "".join(lines)
        assert "warmup done" in out and "on cpu at http://127.0.0.1:" in out
        assert "draining in-flight requests" in out and "drained, bye" in out
    finally:
        if p.poll() is None:
            p.kill()


def test_the_flags_are_the_jax_flags(capsys):
    def flags(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return set(re.findall(r"(?<![\w-])--\w+", capsys.readouterr().out))

    want = flags(jax_serve.main)
    assert flags(serve.main) == want
    assert {"--max_queue", "--compact_output", "--shard_chips", "--warmup"} <= want


@pytest.mark.parametrize("flags,item", [
    (["--shard_chips", "1"], "A8"),
], ids=["shard_chips"])
def test_unported_flags_are_refused(ckpt, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        serve.main(["--model_path", ckpt, *flags], device="cpu")


def test_quantize_int8_serves_the_calibrated_int8_trunk(ckpt, image_arr, tmp_path):
    """``snet-serve --quantize int8 --calib_images``, refused until the int8
    path was ported, as a user runs it (its own process, SIGTERM to stop):
    it calibrates before the warm-up, ``/healthz`` names the trunk, and a
    POSTed PNG's answer is the int8 Predictor's calibrated on the same
    image. tests/test_torch_quant.py holds its parser errors to JAX's."""
    calib = str(tmp_path / "calib.png")
    Image.fromarray(image_arr).save(calib)
    code = ("from selectivenet_for_semantic_segmentation_binary_torch.tools.serve import main\n"
            f"main(['--model_path', {ckpt!r}, '--selective', '1', '--port', '0', "
            f"'--compute_dtype', 'float32', '--quantize', 'int8', '--calib_images', {calib!r}, "
            "'--warmup', '16', '16', '--max_batch', '2'], device='cpu')")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, env=env, text=True)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if "serving UNet_B" in line:
                break
        url = re.search(r"http://127\.0\.0\.1:\d+", lines[-1]).group(0)
        assert json.loads(_request(url + "/healthz")[1])["quantize"] == "int8"
        code, body, _ = _request(url + "/predict", method="POST", data=_png_bytes(image_arr))
        got = json.loads(body)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
    assert "int8 serving trunk: calibrated on 1 images" in "".join(lines)
    padded = _pad_to_grid(image_arr)[0]
    want = _direct(Predictor(ckpt, selective=True, compute_dtype="float32", quantize="int8",
                             calibration_images=[padded], device="cpu"), image_arr)
    assert code == 200 and got["tumor_fraction"] == pytest.approx(float(want["pred"].mean()),
                                                                  abs=1e-6)


@pytest.mark.parametrize("input_type,blankfield", [("GH", False), ("RGB", True)],
                         ids=["GH", "blankfield"])
def test_host_inputs_serve_like_the_jax_server(tmp_path, image_arr, input_type, blankfield):
    """``--input_type GH`` and ``--blankfield 1``, refused until they were
    ported: the port's server (warmed up at the checkpoint's channels and
    the traffic's dtype) and the JAX server, each with the flag, answer the same POSTed
    PNG; the npz maps within NEAR of the JAX Predictor's on the JAX-loaded
    image, the JSON summaries within the near-cut-off allowance."""
    from selectivenet_for_semantic_segmentation_binary_tpu.tools.predict import (
        _load_image as jax_load_image)

    in_ch = 2 if input_type == "GH" else 3
    ckpt = str(tmp_path / "model_epoch1.pth")
    torch.save({"net": seeded_model(33, "float32", selective=True, in_ch=in_ch).state_dict()},
               ckpt)
    assert serve.traffic_dtype(input_type, blankfield) is np.float32
    assert serve.traffic_dtype("RGB", False) is np.uint8
    predictor = Predictor(ckpt, selective=True, compute_dtype="float32", device="cpu")
    assert predictor.in_ch == in_ch
    service = PredictionService(predictor, max_batch=2, request_timeout_s=300.0)
    service.warmup(16, 16, predictor.in_ch, serve.traffic_dtype(input_type, blankfield))
    body = _png_bytes(image_arr)
    with _Running(service, input_type=input_type, blankfield=blankfield) as run:
        code, got_npz, _ = _request(run.url + "/predict?format=npz", method="POST", data=body)
        assert code == 200
        code, got_json, _ = _request(run.url + "/predict", method="POST", data=body)
        assert code == 200
        info = json.loads(_request(run.url + "/info")[1])
        assert info["model"]["input_type"] == input_type
        assert info["model"]["blankfield"] is blankfield
    jax_pred = JaxPredictor(ckpt, selective=True, compute_dtype="float32")
    jax_service = jax_serve.PredictionService(jax_pred, max_batch=1)
    jax_server = jax_serve.make_server(jax_service, "127.0.0.1", 0, input_type=input_type,
                                       blankfield=blankfield)
    threading.Thread(target=jax_server.serve_forever, daemon=True).start()
    try:
        code, want_json, _ = _request(
            f"http://127.0.0.1:{jax_server.server_address[1]}/predict", method="POST",
            data=body)
    finally:
        jax_server.shutdown()
        jax_server.server_close()
        jax_service.close()
    assert code == 200
    padded, h, w = _pad_to_grid(jax_load_image(io.BytesIO(body), input_type, blankfield))
    assert padded.dtype == np.float32 and padded.shape[-1] == in_ch
    ref = {k: v[0, :h, :w] for k, v in jax_pred.predict(padded[None]).items()}
    maps = np.load(io.BytesIO(got_npz))
    for k in ("prob", "selection_prob"):
        np.testing.assert_allclose(maps[k], ref[k], rtol=0, atol=NEAR)
    got, want = json.loads(got_json), json.loads(want_json)
    assert got["shape"] == want["shape"] == [36, 44]
    for key, prob in (("tumor_fraction", "prob"), ("coverage", "selection_prob")):
        allowance = int((np.abs(ref[prob] - 0.5) < NEAR).sum())
        assert abs(got[key] - want[key]) * h * w <= allowance + 1e-9, key


def test_no_device_and_no_card_raises(ckpt, monkeypatch):
    from selectivenet_for_semantic_segmentation_binary_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["serve", "--model_path", ckpt, "--port", "0"])
