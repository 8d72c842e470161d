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
  folding removes only BN, so the folded trunk keeps its dropout sites.

Inputs are (N, H, W, C) raw pixels, uint8 [0, 255] (1 byte a pixel to the
card) or float [0, 1] (the stain and blank-field inputs the host converts,
``tools/predict._load_image``), H and W divisible by 8. C is the
checkpoint's: its first conv's input channels (2 for a GH model,
``in_ch``), as flax infers it from the first input. Every method runs its
forward under its own ``torch.inference_mode()``, a thread-local context,
so the methods may be called from any thread (the server's worker calls
them). The masks are ``prob.float() > float32(cut_off)``, a strict ``>``,
in ``predict`` and ``predict_compact`` alike, so the two give the same masks
bit for bit. Not ported yet, and refused with ``NotImplementedError``:
``quantize="int8"`` (ROADMAP A10).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models import build_model, load_weights
from .ops.fold_bn import fold_batchnorm
from .ops.ingest import device_ingest, normalize_raw
from .train_lib import resolve_device
from .utils.checkpoint import input_channels_of, load_net_checkpoint


class Predictor:
    def __init__(self, checkpoint_path: str, model_arch: str = "UNet_B", n_cls: int = 2,
                 selective: bool = False, compute_dtype: str = "bfloat16",
                 cut_off: float = 0.5, s_cut_off: float = 0.5, fold_bn: bool = True,
                 dropout_rate: float = 0.0, quantize: str = "none",
                 calibration_images=None, device=None):
        if quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize {quantize!r} (expected 'none' or 'int8')")
        if quantize == "int8" or calibration_images is not None:
            raise NotImplementedError("the int8 serving trunk (quantize='int8', "
                                      "calibration_images) is not ported yet: ROADMAP A10")
        self.device = resolve_device(device)
        self.selective = selective
        self.cut_off = cut_off
        self.s_cut_off = s_cut_off
        # the cut-offs as float32 values: comparing a float32 probability
        # with them in any precision is the float32 comparison
        self._cut = float(np.float32(cut_off))
        self._s_cut = float(np.float32(s_cut_off))
        state_dict = load_net_checkpoint(checkpoint_path)
        self.in_ch = input_channels_of(state_dict)
        if fold_bn:
            state_dict = fold_batchnorm(state_dict)
        self.model = build_model(model_arch, n_cls, selective, compute_dtype, folded=fold_bn,
                                 dropout_rate=dropout_rate, in_ch=self.in_ch)
        load_weights(self.model, state_dict)
        self.model.to(self.device)
        self._tiled_apply = None  # built on the first predict_wsi

    # -- core ---------------------------------------------------------------
    def _forward(self, x: torch.Tensor):
        """Raw NHWC pixels on the device -> the model's logits."""
        return self.model(normalize_raw(x).permute(0, 3, 1, 2))

    def _heads(self, x: torch.Tensor):
        out = self._forward(x)
        return (out[0], out[1]) if self.selective else (out, None)

    def logits(self, images) -> torch.Tensor:
        """(N, H, W, C) raw images -> the model's logits on the device (a
        tuple of three heads for a selective model)."""
        with torch.inference_mode():
            return self._forward(device_ingest(images, self.device))

    def predict(self, images) -> Dict[str, np.ndarray]:
        """Returns {'prob', 'pred'[, 'selection_prob', 'selection']}: float32
        probabilities and uint8 masks, (N, H, W)."""
        with torch.inference_mode():
            f, g = self._heads(device_ingest(images, self.device))
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

    def predict_compact(self, images, want_prob: bool = True) -> Dict[str, np.ndarray]:
        """:meth:`predict` with everything on the device and uint8 across:
        ``{'pred', 'prob_u8'[, 'selection', 'selection_prob_u8']}``, or only
        the masks with ``want_prob=False``. The masks are ``predict``'s;
        ``prob_u8 = round(prob * 255)`` (half to even), so ``prob_u8 / 255``
        is within 1/510 of ``prob``."""
        with torch.inference_mode():
            out = self._compact_graph(device_ingest(images, self.device), bool(want_prob))
            return {k: v.cpu().numpy() for k, v in out.items()}

    def _compact_graph(self, x: torch.Tensor, want_prob: bool) -> Dict[str, torch.Tensor]:
        """The device side of :meth:`predict_compact` (JAX ``_build_compact``
        :269)."""

        def to_u8(prob):
            return torch.round(prob.float() * 255.0).to(torch.uint8)

        f, g = self._heads(x)
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
        (windows over several cards) is ROADMAP A8."""
        from .tools.tiled_inference import wsi_mask

        if self._tiled_apply is None:
            # one forward wrapper for the Predictor's lifetime, as the JAX
            # Predictor caches its jitted one
            def apply_fn(batch):
                with torch.inference_mode():
                    out = self._forward(batch)
                return out if isinstance(out, tuple) else (out,)

            self._tiled_apply = apply_fn
        return wsi_mask(None, image, selective=self.selective, cut_off=self.cut_off,
                        s_cut_off=self.s_cut_off, tile=tile, batch_size=batch_size,
                        mesh=mesh, apply_fn=self._tiled_apply, device=self.device)

    # -- uncertainty ----------------------------------------------------------
    def predict_with_uncertainty(self, images, n_iter: int = 32,
                                 seed: int = 0) -> Dict[str, np.ndarray]:
        """(N, H, W, C) raw images -> {'mean_prob' (N, H, W, C), 'variance'
        (N, H, W, C), 'confidence' (N, H, W)} float32 arrays from ``n_iter``
        forwards with dropout live, their masks drawn from a generator on
        the Predictor's device seeded with ``seed`` (JAX predictor.py:343)."""
        from .tools.uncertainty import mc_uncertainty

        generator = torch.Generator(device=self.device).manual_seed(seed)
        x = normalize_raw(device_ingest(images, self.device)).permute(0, 3, 1, 2)
        out = mc_uncertainty(self.model, x, n_iter=n_iter, generator=generator,
                             selective=self.selective)
        return {k: v.cpu().numpy() for k, v in out.items()}
