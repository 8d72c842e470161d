"""Post-training W8A8 int8 quantization for the serving path.

The port's copy of the JAX package's ``ops/quant.py`` (``quantize_kernel``
:49, ``extract_act_scales`` :63, ``merge_act_scales`` :81,
``quantize_folded`` :90, ``quantize_serving`` :139, ``quantized_layer_names``
:168), in numpy as there, on the port's folded state dict
(``ops/fold_bn.py``):

* **weights**: each 3x3 trunk CBR conv (14 a UNet forward) is quantized
  symmetric int8 with one float32 scale per output channel. The port's
  conv weights lie OIHW, so the absmax is over dims (1, 2, 3) where JAX's
  HWIO kernel takes (0, 1, 2). The 1x1 heads and the ``UpConv`` k2s2
  transposed convs pass through as they are (they run in the compute
  dtype);
* **activations**: one static scale a CBR from a calibration pass
  (``models.calibration_absmax``: the folded float32 graph records each
  CBR input's absmax), ``max(absmax, 1e-12) / 127`` in Python doubles,
  stored as float32; the scales of several batches merge by elementwise
  max;
* **arithmetic** (``ops/int8_conv.py``, K10 on the card): x_q =
  clip(round(x / a), +-127); y = conv(x_q, w_q) in int32; y * (a *
  w_scale) + bias; ReLU.

Scale dicts are flat and keyed by the port's module names
(``encoder_layer_1_1``, ...), where JAX nests them under flax scopes
(``{'trunk': {'enc1_1': ...}}``; ``utils/checkpoint.act_scales_from_jax``
maps one onto the other). The quantized state dict holds, for each CBR
``p``, ``p.0.kernel_q`` (int8, OIHW), ``p.0.kernel_scale``, ``p.0.act_scale``
(a 0-dim float32) and ``p.0.bias``, and loads into ``build_model(...,
folded=True, quantize="int8")``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# symmetric int8: 127 levels a sign, no zero point
QMAX = 127.0
# guards degenerate all-zero kernels/activations (a dead calibration channel
# would otherwise produce scale 0 -> division by zero at quantize time)
EPS = 1e-12
# serving calibration runs in chunks of at most this many examples: the
# absmax of a union is the max of the chunks' absmaxes
CALIB_MAX_EXAMPLES = 8

_CONV_SUFFIX = ".0.weight"


def quantize_kernel(weight) -> tuple:
    """(out, in, kh, kw) float weight -> (int8 weight, (out,) float32 scale).

    Symmetric per output channel: scale_c = absmax(weight[c]) / 127 (BN
    folding bakes per-channel gains of very different sizes into the
    weight; one scale for the tensor would crush the small ones)."""
    k = np.asarray(weight, np.float32)
    scale = np.maximum(np.abs(k).max(axis=(1, 2, 3)), EPS) / QMAX
    q = np.clip(np.round(k / scale[:, None, None, None]), -QMAX, QMAX)
    return q.astype(np.int8), scale.astype(np.float32)


def extract_act_scales(absmax: Dict[str, float]) -> Dict[str, float]:
    """{CBR name: input absmax} from a calibration pass -> {CBR name:
    python-float activation scale} (absmax / 127)."""
    return {k: max(float(v), EPS) / QMAX for k, v in absmax.items()}


def merge_act_scales(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Elementwise max of two scale dicts (calibration over several
    batches)."""
    if set(a) != set(b):
        raise ValueError(f"calibration trees disagree: {set(a)} vs {set(b)}")
    return {k: max(a[k], b[k]) for k in a}


def cbr_names(state_dict: Dict[str, torch.Tensor]) -> List[str]:
    """The 3x3 trunk CBRs of a folded state dict, in its order."""
    return [k[:-len(_CONV_SUFFIX)] for k, v in state_dict.items()
            if k.endswith(_CONV_SUFFIX) and v.ndim == 4 and tuple(v.shape[2:]) == (3, 3)]


def quantize_folded(folded: Dict[str, torch.Tensor],
                    act_scales: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The BN-folded float state dict (``ops.fold_bn.fold_batchnorm``) and
    calibrated activation scales -> the state dict of the
    ``quantize="int8"`` serving model. Each CBR's ``.0.weight``/``.0.bias``
    become ``.0.kernel_q`` (int8), ``.0.kernel_scale``, ``.0.act_scale`` and
    ``.0.bias``; the heads and transposed convs pass through. Raises if a
    CBR has no calibrated scale, or a degenerate one (0, NaN, inf):
    quantizing with a default or a poisoned scale would silently garble the
    output."""
    out: Dict[str, torch.Tensor] = {}
    cbrs = set(cbr_names(folded))
    for k, v in folded.items():
        prefix = k.rsplit(".0.", 1)[0]
        if prefix not in cbrs or not k.startswith(prefix + ".0."):
            out[k] = v
            continue
        if k.endswith(".0.bias"):
            continue  # written with the weight
        s = act_scales.get(prefix)
        if not isinstance(s, float):
            raise ValueError(f"no calibrated activation scale for CBR {prefix!r} — run "
                             "calibration over at least one batch before quantizing "
                             "(Predictor.calibrate)")
        if not np.isfinite(s) or s <= 0.0:
            raise ValueError(f"degenerate activation scale {s!r} for CBR {prefix!r} — "
                             "calibrate on representative non-constant images")
        kq, ks = quantize_kernel(v.detach().cpu().numpy())
        out[f"{prefix}.0.kernel_q"] = torch.from_numpy(kq)
        out[f"{prefix}.0.kernel_scale"] = torch.from_numpy(ks)
        out[f"{prefix}.0.act_scale"] = torch.tensor(np.float32(s))
        out[f"{prefix}.0.bias"] = folded[f"{prefix}.0.bias"].detach().cpu().float()
    return out


def calibrate_scales(calib_model: torch.nn.Module, x: torch.Tensor,
                     scales: Dict[str, float] = None) -> Dict[str, float]:
    """Act scales from the ``quant_calibrate`` model over the normalised
    NCHW batch x, in chunks of at most ``CALIB_MAX_EXAMPLES`` examples,
    merged into ``scales`` if given (elementwise max)."""
    from ..models import calibration_absmax

    for i in range(0, x.shape[0], CALIB_MAX_EXAMPLES):
        found = extract_act_scales(calibration_absmax(calib_model,
                                                      x[i:i + CALIB_MAX_EXAMPLES]))
        scales = found if scales is None else merge_act_scales(scales, found)
    return scales


def quantize_serving(model_arch: str, n_cls: int, selective: bool, compute_dtype: str,
                     state_dict: Dict[str, torch.Tensor], calib_images, device,
                     in_ch: int = 3) -> torch.nn.Module:
    """One-shot checkpoint -> quantized serving model on ``device`` (behind
    ``snet-wsi --quantize int8`` and ``snet-eval --quantize int8``; the
    ``Predictor`` keeps its own incremental calibration).

    ``state_dict``: the port's unfolded state dict. ``calib_images``: (N,
    H, W, C) raw [0, 1] float images (dims divisible by 8), normalised as
    (x - 0.5) / 0.5 in float32 on the device."""
    from ..models import build_model, load_weights
    from .fold_bn import fold_batchnorm
    from .ingest import device_ingest, normalize_raw

    folded = fold_batchnorm(state_dict)
    calib_model = build_model(model_arch, n_cls, selective, "float32", folded=True,
                              quant_calibrate=True, in_ch=in_ch)
    load_weights(calib_model, folded).to(device)
    x = normalize_raw(device_ingest(np.asarray(calib_images, np.float32), device))
    scales = calibrate_scales(calib_model, x.permute(0, 3, 1, 2))
    model = build_model(model_arch, n_cls, selective, compute_dtype, folded=True,
                        quantize="int8", in_ch=in_ch)
    return load_weights(model, quantize_folded(folded, scales)).to(device)


def quantized_layer_names(state_dict: Dict[str, torch.Tensor]) -> List[str]:
    """Names of the quantized convs (for logging and tests)."""
    return [k[:-len(".0.kernel_q")] for k in state_dict if k.endswith(".0.kernel_q")]

