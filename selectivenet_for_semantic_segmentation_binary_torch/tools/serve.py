"""Warm inference HTTP server (``snet-serve``).

Counterpart of the JAX package's ``tools/serve.py`` (``_bucket`` :69,
``ServerBusyError`` :77, ``_Request`` :84, ``ServeStats`` :94,
``PredictionService`` :116-327, ``make_server`` :330, ``main`` :512), with
its grouping semantics and flags. One process loads a checkpoint once,
keeps the BN-folded forward on the card, and answers over HTTP:

* **Micro-batching with occupancy buckets.** Concurrent requests whose
  images pad to the same pool-grid shape and have the same dtype share one
  forward; a request of another shape waits at the front of the next batch.
  The batch is padded to the next power of two (capped at ``--max_batch``),
  so a forward sees at most ``log2(max_batch) + 1`` batch sizes per image
  shape (cuDNN picks its algorithms per shape).
* **One worker thread owns the card.** HTTP handler threads decode and
  enqueue; one batcher thread runs every forward.
* **Warm-up at start** (``--warmup H W``): every bucket's forward runs once
  before the server takes traffic.
* **Backpressure** (``--max_queue N``): past N pending requests ``/predict``
  answers 503 with ``Retry-After``.

Endpoints: ``GET /healthz`` (liveness and the backend, ``cuda`` or
``cpu``), ``GET /info`` (configuration and counters), ``GET /metrics``
(the same counters in Prometheus text), ``POST /predict`` (a JPEG/PNG body;
``format=json|png|npz``, ``output=pred|selection`` for png). Images of any
size are edge-padded to the pool grid and the outputs cropped back.

Run on the first card::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.serve \\
        --model_path model_epoch10.pth --selective 1 --port 8500 --warmup 256 256

``--input_type GH`` and ``--blankfield 1`` convert each request on the
host, in its handler thread (``tools/predict._load_image``), and the
requests reach the forward as float32 (GH with 2 channels); the warm-up
runs at those channels and that dtype. ``--quantize int8`` serves the
W8A8 trunk (K10 on the card) and requires ``--calib_images``: the service
calibrates on them before the warm-up, as JAX does; ``/healthz`` then also
reports ``quantize``. ``--shard_chips 1`` splits every device batch over
the visible cards (JAX serve.py:127-157, 279-296, 623-633): the occupancy
buckets are rounded up to a multiple of the card count, and each card runs
its rows on its own replica of the serving trunk (``Predictor(...,
mesh=)``); on one card this is the unsharded forward.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .predict import _collect_inputs, _load_image, _pad_to_grid


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class ServerBusyError(RuntimeError):
    """Raised by :meth:`PredictionService.predict_one` when the pending queue
    is at ``max_queue``; the HTTP layer answers 503 with ``Retry-After``."""


@dataclass
class _Request:
    image: np.ndarray          # (H, W, C) uint8 [0,255] or float32 [0,1], grid-padded
    orig_hw: Tuple[int, int]   # crop target
    want_prob: bool = True     # False (compact services only): masks suffice
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None


@dataclass
class ServeStats:
    n_requests: int = 0
    n_batches: int = 0
    n_errors: int = 0
    n_rejected: int = 0  # backpressure 503s (max_queue exceeded)
    occupancy_sum: int = 0
    padded_sum: int = 0
    shapes: set = field(default_factory=set)

    def as_dict(self) -> Dict:
        batches = max(self.n_batches, 1)
        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "n_errors": self.n_errors,
            "n_rejected": self.n_rejected,
            "mean_occupancy": self.occupancy_sum / batches,
            "mean_padded_batch": self.padded_sum / batches,
            "shapes_seen": sorted(list(self.shapes)),
        }


class PredictionService:
    """Micro-batching wrapper around the serving ``Predictor``.

    ``predict_one(image)`` blocks the calling thread until its request has
    been served as part of a device batch; many threads may call it at once,
    and concurrent callers share a forward. ``compact_output`` serves
    through ``Predictor.predict_compact`` (uint8 across; a group whose
    requests all declare ``want_prob=False`` gets masks only, a mixed group
    the probabilities too). ``mesh`` (``parallel.mesh.make_mesh``) splits
    each device batch over its cards on dim 0."""

    def __init__(self, predictor, max_batch: int = 8, batch_window_ms: float = 5.0,
                 request_timeout_s: float = 1800.0, mesh=None, max_queue: int = 0,
                 compact_output: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.predictor = predictor
        # the device batch is split on dim 0 over the mesh's cards: no
        # communication between them, as for --shard_windows
        self.mesh = mesh
        self._n_dev = mesh.size if mesh is not None else 1
        self.compact_output = bool(compact_output)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)  # 0: unbounded
        self.batch_window_s = float(batch_window_ms) / 1000.0
        self.request_timeout_s = float(request_timeout_s)
        self.stats = ServeStats()
        self._stats_lock = threading.Lock()
        self._pending = 0  # accepted, not yet completed (under _stats_lock)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._leftover: List[_Request] = []  # wrong-shape requests pulled early
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="snet-serve-batcher")
        self._worker.start()

    # -- public ---------------------------------------------------------------
    def predict_one(self, image: np.ndarray, want_prob: bool = True) -> Dict[str, np.ndarray]:
        """One (H, W, C) raw image (float [0, 1] or uint8 [0, 255]) ->
        {'prob', 'pred'[, 'selection_prob', 'selection']}, each cropped back
        to (H, W). ``want_prob=False`` (meaningful on a ``compact_output``
        service only) says the caller reads the masks only."""
        with self._stats_lock:
            if self.max_queue and self._pending >= self.max_queue:
                self.stats.n_rejected += 1
                raise ServerBusyError(f"{self._pending} requests already pending "
                                      f"(max_queue={self.max_queue}); retry shortly")
            self._pending += 1
        try:
            padded, h, w = _pad_to_grid(np.asarray(image))
            req = _Request(image=padded, orig_hw=(h, w),
                           want_prob=bool(want_prob) or not self.compact_output)
        except BaseException:
            # release the slot reserved above, or max_queue capacity leaks
            with self._stats_lock:
                self._pending -= 1
            raise
        self._queue.put(req)
        if not req.done.wait(self.request_timeout_s):
            raise TimeoutError(f"prediction not served within "
                               f"{self.request_timeout_s:.0f}s (raise --request_timeout_s)")
        if req.error is not None:
            raise req.error
        return req.result

    def warmup(self, h: int, w: int, channels: int, dtype=np.float32) -> None:
        """Run the forward for (h, w) at every occupancy bucket (both graphs
        of a compact service), so the first requests find cuDNN's
        algorithms chosen and the allocator's blocks cached. ``dtype`` is
        the traffic's (uint8 for plain RGB)."""
        img = np.zeros((h, w, channels), dtype)
        variants = (True, False) if self.compact_output else (True,)
        for b in sorted({self._padded_size(n) for n in range(1, self.max_batch + 1)}):
            for wp in variants:
                self._forward_group([_Request(image=_pad_to_grid(img)[0], orig_hw=(h, w),
                                              want_prob=wp) for _ in range(b)])

    def close(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=30.0)

    # -- worker ---------------------------------------------------------------
    def _take(self, timeout: Optional[float]) -> Optional[_Request]:
        """Next pending request: leftovers first, then the queue."""
        if self._leftover:
            return self._leftover.pop(0)
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def _run(self) -> None:
        while True:
            first = self._take(timeout=None)
            if first is None:  # close() sentinel
                return
            group = [first]
            deadline = time.monotonic() + self.batch_window_s
            mismatched: List[_Request] = []
            while len(group) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=rem)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-arm the sentinel, serve the group
                    break
                if (nxt.image.shape == first.image.shape
                        and nxt.image.dtype == first.image.dtype):
                    group.append(nxt)
                else:
                    mismatched.append(nxt)
            # wrong-shape requests go to the FRONT of the next iteration, so a
            # steady same-shape stream cannot starve them
            self._leftover.extend(mismatched)
            try:
                self._forward_group(group)
            except Exception as e:  # noqa: BLE001 - delivered to each request
                with self._stats_lock:
                    self.stats.n_errors += len(group)
                for r in group:
                    r.error = e
                    r.done.set()
            finally:
                with self._stats_lock:
                    self._pending -= len(group)

    def _padded_size(self, n: int) -> int:
        """Device rows for n requests: the power-of-two occupancy bucket,
        rounded up to a multiple of the mesh's cards so every card gets as
        many rows."""
        b = _bucket(n, self.max_batch)
        return -(-b // self._n_dev) * self._n_dev

    def _forward_group(self, group: List[_Request]) -> None:
        batch = np.stack([r.image for r in group])
        n = len(group)
        b = self._padded_size(n)
        if b > n:  # occupancy padding: one batch size for 1..b requests
            pad = np.zeros((b - n,) + batch.shape[1:], batch.dtype)
            batch = np.concatenate([batch, pad], axis=0)
        kw = {} if self.mesh is None else {"mesh": self.mesh}
        if self.compact_output:
            # masks only when EVERY request of the group agrees; a mixed
            # group upgrades to the prob graph (a superset of the answer)
            want_prob = any(r.want_prob for r in group)
            out = self.predictor.predict_compact(batch, want_prob=want_prob, **kw)
        else:
            out = self.predictor.predict(batch, **kw)
        with self._stats_lock:
            self.stats.n_requests += n
            self.stats.n_batches += 1
            self.stats.occupancy_sum += n
            self.stats.padded_sum += b
            self.stats.shapes.add(batch.shape[1:3])
        for i, r in enumerate(group):
            h, w = r.orig_hw
            res = {k: v[i, :h, :w] for k, v in out.items()}
            if self.compact_output:  # the same schema, quantised to 1/255
                if "prob_u8" in res:
                    res["prob"] = res.pop("prob_u8").astype(np.float32) / 255.0
                if "selection_prob_u8" in res:
                    res["selection_prob"] = (
                        res.pop("selection_prob_u8").astype(np.float32) / 255.0)
            r.result = res
            r.done.set()


def traffic_dtype(input_type: str, blankfield: bool) -> type:
    """The dtype of the images ``_load_image`` hands the service: uint8 for
    plain RGB, float32 for a host-converted input (JAX ``main`` :635-640);
    the warm-up runs at it and at the checkpoint's channels."""
    return np.uint8 if input_type == "RGB" and not blankfield else np.float32


# -- HTTP layer ----------------------------------------------------------------

def make_server(service: PredictionService, host: str, port: int, input_type: str = "RGB",
                blankfield: bool = False, max_body_mb: float = 64.0,
                model_info: Optional[Dict] = None):
    """Build (not start) a ThreadingHTTPServer serving ``service``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    started = time.monotonic()
    max_body = int(max_body_mb * 1024 * 1024)
    backend = service.predictor.device.type
    info = dict(model_info or {})
    info.update({"input_type": input_type, "blankfield": bool(blankfield),
                 "max_batch": service.max_batch, "max_queue": service.max_queue,
                 "batch_window_ms": service.batch_window_s * 1000.0, "n_chips": 1})

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102 - keep stderr quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: Dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802 - http.server API
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"status": "ok", "backend": backend,
                                      "quantize": info.get("quantize", "none"),
                                      "uptime_s": round(time.monotonic() - started, 3)})
            elif path == "/info":
                with service._stats_lock:
                    stats = service.stats.as_dict()
                self._send_json(200, {"model": info, "stats": stats})
            elif path == "/metrics":
                with service._stats_lock:
                    s = service.stats
                    pending = service._pending
                    lines = [
                        "# HELP snet_requests_total requests served",
                        "# TYPE snet_requests_total counter",
                        f"snet_requests_total {s.n_requests}",
                        "# HELP snet_batches_total device batches executed",
                        "# TYPE snet_batches_total counter",
                        f"snet_batches_total {s.n_batches}",
                        "# HELP snet_errors_total requests failed in the forward",
                        "# TYPE snet_errors_total counter",
                        f"snet_errors_total {s.n_errors}",
                        "# HELP snet_rejected_total requests shed by max_queue backpressure",
                        "# TYPE snet_rejected_total counter",
                        f"snet_rejected_total {s.n_rejected}",
                        "# HELP snet_batch_occupancy_sum real requests summed over batches",
                        "# TYPE snet_batch_occupancy_sum counter",
                        f"snet_batch_occupancy_sum {s.occupancy_sum}",
                        "# HELP snet_batch_padded_sum padded device rows summed over batches",
                        "# TYPE snet_batch_padded_sum counter",
                        f"snet_batch_padded_sum {s.padded_sum}",
                        "# HELP snet_pending_requests accepted, not yet completed",
                        "# TYPE snet_pending_requests gauge",
                        f"snet_pending_requests {pending}",
                        "# HELP snet_uptime_seconds time since server build",
                        "# TYPE snet_uptime_seconds gauge",
                        f"snet_uptime_seconds {time.monotonic() - started:.3f}",
                    ]
                self._send(200, ("\n".join(lines) + "\n").encode(), "text/plain; version=0.0.4")
            else:
                self._send_json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/predict":
                self.close_connection = True
                self._send_json(404, {"error": f"unknown path {url.path}"})
                return
            q = parse_qs(url.query)
            fmt = q.get("format", ["json"])[0]
            output = q.get("output", ["pred"])[0]
            # a rejection before the body is read closes the connection, or
            # the unread bytes corrupt the next keep-alive request
            if fmt not in ("json", "png", "npz"):
                self.close_connection = True
                self._send_json(400, {"error": f"unknown format {fmt!r} (json|png|npz)"})
                return
            if output not in ("pred", "selection"):
                self.close_connection = True
                self._send_json(400, {"error": f"unknown output {output!r} (pred|selection)"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            if length <= 0:
                self.close_connection = True
                self._send_json(400, {"error": "empty request body (POST the image bytes)"})
                return
            if length > max_body:
                self.close_connection = True
                self._send_json(413, {"error": f"body {length} B exceeds limit {max_body} B"})
                return
            body = self.rfile.read(length)
            try:
                image = _load_image(io.BytesIO(body), input_type, blankfield)
            except Exception as e:  # noqa: BLE001 - a client error
                self._send_json(400, {"error": f"could not decode image: {e}"})
                return
            try:
                # json and png read only the masks; npz needs the prob graph
                out = service.predict_one(image, want_prob=(fmt == "npz"))
            except ServerBusyError as e:
                self._send(503, json.dumps({"error": str(e)}).encode(), "application/json",
                           headers={"Retry-After": "1"})
                return
            except TimeoutError as e:
                self._send_json(504, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                self._send_json(500, {"error": f"prediction failed: {e}"})
                return
            self._respond(out, fmt, output, image.shape)

        def _respond(self, out: Dict[str, np.ndarray], fmt: str, output: str, shape) -> None:
            if fmt == "json":
                resp = {"shape": [int(shape[0]), int(shape[1])],
                        "tumor_fraction": float(out["pred"].mean())}
                if "selection" in out:
                    resp["coverage"] = float(out["selection"].mean())
                self._send_json(200, resp)
            elif fmt == "png":
                if output == "selection" and "selection" not in out:
                    self._send_json(400, {"error": "output=selection needs a "
                                                   "selective checkpoint"})
                    return
                from PIL import Image

                # CE-head class ids spread evenly over the gray levels
                scale = (255 // max(int(info.get("n_cls", 2)) - 1, 1)
                         if output == "pred" else 255)
                arr = out[output].astype(np.uint8) * np.uint8(scale)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:  # npz
                buf = io.BytesIO()
                np.savez_compressed(buf, **{k: np.asarray(v) for k, v in out.items()})
                self._send(200, buf.getvalue(), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def build_parser():
    """The JAX ``snet-serve`` flag surface."""
    import argparse

    from ..config import parse_bool

    parser = argparse.ArgumentParser(
        description="warm inference HTTP server over the serving Predictor "
                    "(micro-batched, BN-folded forward)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--model_path", default=None, help="one .pth/.ckpt checkpoint")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: its digit-latest model_epoch{N} file is used")
    parser.add_argument("--model_arch", default="UNet_B",
                        choices=["UNet", "UNet_B", "TransUNet"])
    parser.add_argument("--n_cls", type=int, default=2)
    parser.add_argument("--selective", type=parse_bool, default=False)
    parser.add_argument("--input_type", default="RGB", choices=["RGB", "GH"])
    parser.add_argument("--blankfield", type=parse_bool, default=False)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--cut_off", type=float, default=0.5)
    parser.add_argument("--s_cut_off", type=float, default=0.5)
    parser.add_argument("--fold_bn", type=parse_bool, default=None,
                        help="fold BatchNorm into the convs (serving graph); default 1, "
                             "and 0 for TransUNet, which has no folded graph")
    parser.add_argument("--quantize", default="none", choices=["none", "int8"])
    parser.add_argument("--calib_images", nargs="+", default=None, metavar="PATH")
    parser.add_argument("--max_batch", type=int, default=8,
                        help="micro-batch cap; occupancies are padded to powers of two "
                             "up to this")
    parser.add_argument("--shard_chips", type=parse_bool, default=False)
    parser.add_argument("--batch_window_ms", type=float, default=5.0,
                        help="how long the batcher waits to fill a batch after the "
                             "first request arrives")
    parser.add_argument("--max_queue", type=int, default=0,
                        help="backpressure: cap on accepted-but-unserved requests, past "
                             "which /predict answers 503 + Retry-After; 0 = unbounded")
    parser.add_argument("--compact_output", type=parse_bool, default=False,
                        help="threshold and quantise on the device and ship every "
                             "response plane as uint8 (Predictor.predict_compact)")
    parser.add_argument("--request_timeout_s", type=float, default=1800.0)
    parser.add_argument("--max_body_mb", type=float, default=64.0)
    parser.add_argument("--warmup", type=int, nargs=2, default=None, metavar=("H", "W"),
                        help="run the forward for this image size (every occupancy "
                             "bucket) before accepting traffic")
    return parser


def main(argv=None, device=None) -> None:
    """CLI: python -m selectivenet_for_semantic_segmentation_binary_torch.tools.serve.
    Runs on ``cuda:0`` unless ``device`` names another device. SIGTERM
    stops accepting, lets in-flight requests finish, drains the batcher and
    returns."""
    parser = build_parser()
    a = parser.parse_args(argv)
    if a.fold_bn is None:
        a.fold_bn = a.model_arch != "TransUNet"
    if a.max_batch < 1:
        parser.error(f"--max_batch must be >= 1, got {a.max_batch}")
    from ..utils.checkpoint import resolve_checkpoint

    try:
        ckpt = resolve_checkpoint(a.model_path, a.model_dir)
    except ValueError as e:
        parser.error(str(e))

    from ..config import check_input_channels
    from ..predictor import Predictor

    if a.quantize == "int8":
        if not a.calib_images:
            parser.error("--quantize int8 requires --calib_images: the "
                         "server must calibrate activation scales before "
                         "warmup/traffic (lazy first-request calibration "
                         "would recompile after warmup)")
        if not a.fold_bn:
            parser.error("--quantize int8 requires --fold_bn 1 (the int8 "
                         "trunk consumes BN-folded weights, ops/quant.py)")
    elif a.calib_images:
        parser.error("--calib_images without --quantize int8 has no effect")

    predictor = Predictor(ckpt, model_arch=a.model_arch, n_cls=a.n_cls,
                          selective=a.selective, compute_dtype=a.compute_dtype,
                          cut_off=a.cut_off, s_cut_off=a.s_cut_off, fold_bn=a.fold_bn,
                          quantize=a.quantize, device=device)
    check_input_channels(parser, a.input_type, predictor.in_ch)
    if a.quantize == "int8":
        calib = [_pad_to_grid(_load_image(p, a.input_type, a.blankfield))[0]
                 for p in _collect_inputs(a.calib_images)]
        predictor.calibrate(calib)
        print(f"int8 serving trunk: calibrated on {len(calib)} images", flush=True)
    mesh = None
    if a.shard_chips:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
        print(f"sharding device batches over {mesh.size} cards", flush=True)
    service = PredictionService(predictor, max_batch=a.max_batch,
                                batch_window_ms=a.batch_window_ms,
                                request_timeout_s=a.request_timeout_s, mesh=mesh,
                                max_queue=a.max_queue, compact_output=a.compact_output)
    if a.warmup:
        h, w = a.warmup
        print(f"warming up {h}x{w} (buckets up to {a.max_batch})...", flush=True)
        t0 = time.monotonic()
        service.warmup(h, w, predictor.in_ch, traffic_dtype(a.input_type, a.blankfield))
        print(f"warmup done in {time.monotonic() - t0:.1f}s", flush=True)

    model_info = {
        "checkpoint": ckpt, "model_arch": a.model_arch, "n_cls": a.n_cls,
        "selective": bool(a.selective), "compute_dtype": a.compute_dtype,
        "cut_off": a.cut_off, "s_cut_off": a.s_cut_off, "fold_bn": bool(a.fold_bn),
        "quantize": a.quantize, "compact_output": bool(a.compact_output),
    }
    server = make_server(service, a.host, a.port, input_type=a.input_type,
                         blankfield=a.blankfield, max_body_mb=a.max_body_mb,
                         model_info=model_info)
    # graceful SIGTERM: stop accepting, let in-flight requests finish
    # (server_close joins the handler threads), drain the batcher. shutdown()
    # must run off the serve_forever thread or it deadlocks. Installed before
    # the "serving" line, so a stop sent on seeing that line is graceful.
    import signal

    def _graceful(signum, frame):  # noqa: ARG001 - signal API
        print("SIGTERM: draining in-flight requests...", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    print(f"serving {a.model_arch} (selective={bool(a.selective)}) on {predictor.device} "
          f"at http://{a.host}:{server.server_address[1]}  "
          f"(POST /predict, GET /healthz, GET /info, GET /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        server.server_close()
        service.close()
        print("drained, bye", flush=True)


if __name__ == "__main__":
    main()
