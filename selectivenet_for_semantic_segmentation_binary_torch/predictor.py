"""Serving-side predictor: one object from a checkpoint to predictions.

Counterpart of the JAX package's ``predictor.py`` (``Predictor`` :55-360):

* loads a port ``.pth``, a reference ``.pth`` or a JAX ``.ckpt``
  (``utils/checkpoint.py``);
* folds BatchNorm into the convs (``ops/fold_bn.py``) and serves the folded
  trunk, conv and ReLU only, in bfloat16 by default (``fold_bn=False``
  serves the eval-mode model with its BatchNorms);
* ``predict``: batched probabilities and masks at ``cut_off``;
* ``predict_compact``: sigmoid, threshold and quantisation on the device,
  and every output crosses to the host as uint8 (masks exact,
  probabilities quantised to 1/255);
* ``predict_wsi``: exact seamless whole-slide masks with bounded memory
  (``tools/tiled_inference.py``);
* ``predict_with_uncertainty``: MC-dropout mean, variance and confidence
  (``tools/uncertainty.py``) of a Predictor built with ``dropout_rate > 0``;
  folding removes only BN, so the folded trunk keeps its dropout sites;
* ``model_arch="TransUNet"`` serves unfolded (``fold_bn=False``; it has no
  folded graph, and ``fold_bn=True`` is refused) at the input side of its
  checkpoint's position embedding;
* ``quantize="int8"``: the W8A8 serving trunk (``ops/quant.py``; each CBR
  one launch of K10, ``kernels/int8_conv.cu``, on the card; the heads and
  ``UpConv``s in the compute dtype). Its activation scales come from
  ``calibration_images`` or ``calibrate()``, which run the float32 folded
  graph (TF32 off) in chunks of at most 8 examples and merge by
  elementwise max, or else lazily from the first batch of ``predict``,
  ``predict_compact`` or ``logits``, or from a centre crop of at most
  1024x1024 of the first slide of ``predict_wsi``.

Several cards (JAX ``mesh=``, ``--shard_windows`` and ``--shard_chips 1``):
``predict``, ``predict_compact`` and ``predict_wsi`` take a
``parallel.mesh.Mesh``, split each batch on dim 0 over its cards and run
each part on that card's replica of the serving trunk (the model itself on
the Predictor's device, a copy elsewhere, made at first use and again after
an int8 calibration); the outputs are gathered on the mesh's first card. On
one card this is the unsharded forward.

Inputs are (N, H, W, C) raw pixels, uint8 [0, 255] (1 byte a pixel to the
card) or float [0, 1] (the stain and blank-field inputs the host converts,
``tools/predict._load_image``), H and W divisible by 8. C is the
checkpoint's: its first conv's input channels (2 for a GH model,
``in_ch``), as flax infers it from the first input. Every method runs its
forward under its own ``torch.inference_mode()``, a thread-local context,
so the methods may be called from any thread (the server's worker calls
them). The masks are ``prob.float() > float32(cut_off)``, a strict ``>``,
in ``predict`` and ``predict_compact`` alike, so the two give the same masks
bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from .models import build_model, load_weights
from .models.transunet import img_size_of
from .ops.fold_bn import fold_batchnorm
from .ops.ingest import device_ingest, normalize_raw
from .parallel.mesh import replicas, shard_apply
from .train_lib import resolve_device
from .utils import tracing
from .utils.checkpoint import input_channels_of, load_net_checkpoint

# the trunk max-pools 3x: serving inputs need dims % 8 == 0; the lazy
# calibration on a slide takes a centre crop of at most this size
_GRID = 8
_CALIB_MAX_DIM = 1024
_CALLS = itertools.count()  # the key of each traced ``predict_compact`` call


class Predictor:
    def __init__(self, checkpoint_path: str, model_arch: str = "UNet_B", n_cls: int = 2,
                 selective: bool = False, compute_dtype: str = "bfloat16",
                 cut_off: float = 0.5, s_cut_off: float = 0.5, fold_bn: bool = True,
                 dropout_rate: float = 0.0, quantize: str = "none",
                 calibration_images=None, device=None):
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize {quantize!r} (expected 'none' or 'int8')")
        if model_arch == "TransUNet" and (fold_bn or quantize != "none"):
            raise ValueError("TransUNet has no folded or int8 serving graph: serve it with "
                             "fold_bn=False and quantize='none'")
        self.device = resolve_device(device)
        self.selective = selective
        self.cut_off = cut_off
        self.s_cut_off = s_cut_off
        self.quantize = quantize
        # the cut-offs as float32 values: comparing a float32 probability
        # with them in any precision is the float32 comparison
        self._cut = float(np.float32(cut_off))
        self._s_cut = float(np.float32(s_cut_off))
        state_dict = load_net_checkpoint(checkpoint_path)
        self.in_ch = input_channels_of(state_dict)
        self._tiled_apply = None  # built on the first predict_wsi
        self._sharded_tiled = {}  # the same, a mesh each
        self._replicas = {}  # the serving trunk on the mesh's other cards
        self._calibrated = True
        if quantize == "int8":
            if not fold_bn:
                raise ValueError("quantize='int8' requires fold_bn=True — the int8 trunk "
                                 "consumes BN-folded weights (ops/quant.py)")
            if dropout_rate > 0:
                raise ValueError("quantize='int8' and dropout_rate > 0 are exclusive "
                                 "(MC-dropout uncertainty runs the bf16 folded graph)")
            self._folded = fold_batchnorm(state_dict)
            # calibration runs the float32 folded graph, so that the absmax
            # statistics are not themselves rounded to bf16
            self._calib_model = load_weights(
                build_model(model_arch, n_cls, selective, "float32", folded=True,
                            quant_calibrate=True, in_ch=self.in_ch), self._folded).to(self.device)
            self._act_scales = None  # merged calibration scales (ops/quant.py)
            self.model = build_model(model_arch, n_cls, selective, compute_dtype, folded=True,
                                     quantize="int8", in_ch=self.in_ch).to(self.device)
            self._calibrated = False
            if calibration_images is not None:
                self.calibrate(calibration_images)
            return
        if fold_bn:
            state_dict = fold_batchnorm(state_dict)
        # a TransUNet serves the input side its position embedding was built for
        arch = {"img_size": img_size_of(state_dict)} if model_arch == "TransUNet" else {}
        self.model = build_model(model_arch, n_cls, selective, compute_dtype, folded=fold_bn,
                                 dropout_rate=dropout_rate, in_ch=self.in_ch, **arch)
        load_weights(self.model, state_dict)
        self.model.to(self.device)

    # -- int8 calibration -----------------------------------------------------
    def calibrate(self, images) -> None:
        """Calibrate the int8 activation scales on raw images (float [0, 1]
        or uint8 [0, 255]) and load the quantized trunk.

        ``images``: one (N, H, W, C) batch or a sequence of (H, W, C) images
        (sizes may differ; dims must divide 8). Repeated calls merge the
        scales by elementwise max, so scales only widen."""
        if self.quantize != "int8":
            raise ValueError("calibrate() is only meaningful for Predictor(quantize='int8')")
        if isinstance(images, np.ndarray) and images.ndim == 3:
            images = [images]
        batches = ([images] if isinstance(images, np.ndarray)
                   else [np.asarray(im)[None] if np.asarray(im).ndim == 3 else np.asarray(im)
                         for im in images])
        for batch in batches:
            self._calibrate_normalized(normalize_raw(device_ingest(batch, self.device)))

    def _calibrate_normalized(self, x: torch.Tensor) -> None:
        """One normalised NHWC batch on the device -> merged scales and the
        quantized trunk (``ops.quant.calibrate_scales``: chunks of at most 8
        examples, exact since the absmax of a union is the max of its
        chunks')."""
        from .ops.quant import calibrate_scales, quantize_folded

        self._act_scales = calibrate_scales(self._calib_model, x.permute(0, 3, 1, 2),
                                            self._act_scales)
        load_weights(self.model, quantize_folded(self._folded, self._act_scales))
        self._replicas = {}  # copies of the trunk before these scales
        self._calibrated = True

    def _ingest(self, images) -> torch.Tensor:
        """Raw images on the device; an int8 Predictor not yet calibrated
        calibrates on them first."""
        x = device_ingest(images, self.device)
        if not self._calibrated:
            self._calibrate_normalized(normalize_raw(x))
        return x

    # -- core ---------------------------------------------------------------
    def _forward(self, x: torch.Tensor, mesh=None):
        """Raw NHWC pixels on the device -> the model's logits; with
        ``mesh``, split over its cards and gathered on its first."""
        if mesh is None:
            return self.model(normalize_raw(x).permute(0, 3, 1, 2))
        fns = [lambda c, m=m: m(normalize_raw(c).permute(0, 3, 1, 2))
               for m in replicas(self.model, self.device, mesh, self._replicas)]
        return shard_apply(fns, x, mesh)

    def _heads(self, x: torch.Tensor, mesh=None):
        out = self._forward(x, mesh)
        return (out[0], out[1]) if self.selective else (out, None)

    def logits(self, images) -> torch.Tensor:
        """(N, H, W, C) raw images -> the model's logits on the device (a
        tuple of three heads for a selective model)."""
        x = self._ingest(images)
        with torch.inference_mode():
            return self._forward(x)

    def predict(self, images, mesh=None) -> Dict[str, np.ndarray]:
        """Returns {'prob', 'pred'[, 'selection_prob', 'selection']}: float32
        probabilities and uint8 masks, (N, H, W); ``mesh`` splits the batch
        over its cards."""
        x = self._ingest(images)
        with torch.inference_mode():
            f, g = self._heads(x, mesh)
            if f.ndim == 3:
                prob = torch.sigmoid(f)
                pred = (prob.float() > self._cut).to(torch.uint8)
            else:
                prob = torch.softmax(f, dim=-1)[..., 1]
                pred = f.argmax(-1).to(torch.uint8)
            result = {"prob": prob, "pred": pred}
            if g is not None:
                sp = torch.sigmoid(g) if g.ndim == 3 else torch.softmax(g, dim=-1)[..., 1]
                result["selection_prob"] = sp
                result["selection"] = (sp.float() > self._s_cut).to(torch.uint8)
            return {k: v.cpu().numpy() for k, v in result.items()}

    def predict_compact(self, images, want_prob: bool = True,
                        mesh=None) -> Dict[str, np.ndarray]:
        """:meth:`predict` with everything on the device and uint8 across:
        ``{'pred', 'prob_u8'[, 'selection', 'selection_prob_u8']}``, or only
        the masks with ``want_prob=False``. The masks are ``predict``'s;
        ``prob_u8 = round(prob * 255)`` (half to even), so ``prob_u8 / 255``
        is within 1/510 of ``prob``.

        Traced (``utils/tracing.py``) as ``predict`` with ``predict.ingest``
        (to the device, and a lazy calibration), ``predict.forward`` (the
        graph enqueued) and ``predict.fetch`` (the planes copied back), one
        key a call."""
        key = next(_CALLS)
        with tracing.span("predict", key):
            with tracing.span("predict.ingest", key):
                x = self._ingest(images)
            with torch.inference_mode():
                with tracing.span("predict.forward", key):
                    out = self._compact_graph(x, bool(want_prob), mesh)
                with tracing.span("predict.fetch", key):
                    return {k: v.cpu().numpy() for k, v in out.items()}

    def _compact_graph(self, x: torch.Tensor, want_prob: bool,
                       mesh=None) -> Dict[str, torch.Tensor]:
        """The device side of :meth:`predict_compact` (JAX ``_build_compact``
        :269)."""

        def to_u8(prob):
            return torch.round(prob.float() * 255.0).to(torch.uint8)

        f, g = self._heads(x, mesh)
        res = {}
        if f.ndim == 3:
            prob = torch.sigmoid(f)
            res["pred"] = (prob.float() > self._cut).to(torch.uint8)
        else:
            prob = torch.softmax(f, dim=-1)[..., 1]
            res["pred"] = f.argmax(-1).to(torch.uint8)
        if want_prob:
            res["prob_u8"] = to_u8(prob)
        if g is not None:
            sp = torch.sigmoid(g) if g.ndim == 3 else torch.softmax(g, dim=-1)[..., 1]
            res["selection"] = (sp.float() > self._s_cut).to(torch.uint8)
            if want_prob:
                res["selection_prob_u8"] = to_u8(sp)
        return res

    # -- whole-slide --------------------------------------------------------
    def predict_wsi(self, image, tile=(512, 512), batch_size: int = 8,
                    mesh=None) -> Dict[str, np.ndarray]:
        """Exact seamless full-slide inference of one (H, W, C) raw image
        (float [0, 1] or uint8 [0, 255]); H and W divisible by 8. ``mesh``
        splits each window batch over its cards (``--shard_windows``). An
        int8 Predictor not yet calibrated calibrates on a centre crop of the
        slide (at most 1024x1024) first."""
        from .tools.tiled_inference import wsi_mask

        if not self._calibrated:
            self.calibrate(_center_crop(np.asarray(image))[None])
        def make_apply(m):
            def apply_fn(batch):
                with torch.inference_mode():
                    out = self._forward(batch, m)
                return out if isinstance(out, tuple) else (out,)
            return apply_fn

        # one forward wrapper for the Predictor's lifetime (a mesh each), as
        # the JAX Predictor caches its jitted one
        if mesh is None:
            if self._tiled_apply is None:
                self._tiled_apply = make_apply(None)
            apply_fn = self._tiled_apply
        else:
            apply_fn = self._sharded_tiled.setdefault(mesh, make_apply(mesh))
        return wsi_mask(None, image, selective=self.selective, cut_off=self.cut_off,
                        s_cut_off=self.s_cut_off, tile=tile, batch_size=batch_size,
                        mesh=mesh, apply_fn=apply_fn, device=self.device)

    # -- uncertainty ----------------------------------------------------------
    def predict_with_uncertainty(self, images, n_iter: int = 32,
                                 seed: int = 0) -> Dict[str, np.ndarray]:
        """(N, H, W, C) raw images -> {'mean_prob' (N, H, W, C), 'variance'
        (N, H, W, C), 'confidence' (N, H, W)} float32 arrays from ``n_iter``
        forwards with dropout live, their masks drawn from a generator on
        the Predictor's device seeded with ``seed`` (JAX predictor.py:343)."""
        from .tools.uncertainty import mc_uncertainty

        if self.quantize != "none":
            raise ValueError("MC-dropout uncertainty runs the bf16 folded graph; build the "
                             "Predictor with quantize='none'")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        x = normalize_raw(device_ingest(images, self.device)).permute(0, 3, 1, 2)
        out = mc_uncertainty(self.model, x, n_iter=n_iter, generator=generator,
                             selective=self.selective)
        return {k: v.cpu().numpy() for k, v in out.items()}


def _center_crop(image: np.ndarray) -> np.ndarray:
    """(H, W, C) -> its grid-aligned centre crop of at most 1024x1024 (JAX
    predictor.py:357-366)."""
    h, w = image.shape[:2]
    ch = min(_CALIB_MAX_DIM, h - h % _GRID)
    cw = min(_CALIB_MAX_DIM, w - w % _GRID)
    if ch <= 0 or cw <= 0:
        raise ValueError(f"image too small to calibrate on: {h}x{w} "
                         f"(needs >= {_GRID} in both dims)")
    y0 = (h - ch) // 2
    x0 = (w - cw) // 2
    return image[y0:y0 + ch, x0:x0 + cw]
