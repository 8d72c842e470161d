"""Ahead-of-time export of the serving forward as a portable artifact
(``snet-export``).

Counterpart of the JAX package's ``tools/export.py:35-227``, with
``torch.export`` where JAX writes StableHLO. The artifact freezes the
serving pipeline: normalisation (x - 0.5) / 0.5, the ``Predictor``'s trunk
(BN-folded by default, in its compute dtype) and the output activations,
weights baked in:

* self-contained: the consumer needs ``torch`` alone, not this package:
  ``torch.export.load(path).module()(images)``;
* ``images`` float32 [0, 1] NHWC of exactly the exported shape (another
  shape raises at the call); it returns ``{"prob": float32 (N, H, W)[,
  "selection_prob": float32 (N, H, W)]}``, sigmoid of a UNet_B head or
  softmax[..., 1] of a UNet head: probability maps, thresholds are the
  consumer's choice;
* the artifact's tensors live on one device, the first of ``--platforms``
  (``cpu`` or ``cuda``; ``tpu`` is refused): a program exported for one
  device runs on the other after
  ``torch.export.passes.move_to_device_pass(program, device)``, which
  ``load_exported(path, device)`` applies, and ``--check 1`` runs it on
  every listed device present;
* a JSON sidecar (``{out}.json``) documents shape, dtype, architecture and
  provenance.

The graph is the classic trunk's and runs no custom kernel: the fused
trunk's kernel is a ``ctypes`` call, which ``torch.export`` cannot trace,
and the serving trunk is the folded classic one (phase 16 of
``chip_smoke.py``). A bfloat16 artifact holds bf16 weights and no
autocast region: autocast rounds the same float32 weights and
activations to bf16 at the same convs, so it computes what the
``Predictor``'s autocast forward computes. uint8 ingest stays out, as in
the JAX artifact. Static shapes: export one artifact a serving shape;
``snet-serve`` covers the variable-shape online case.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .tiled_inference import GRID

PLATFORMS = ("cpu", "cuda")
# --check: the artifact against the live Predictor.predict on the same
# images; bf16 is the serving path's bound (chip_smoke.py SERVE_PROB_TOL)
CHECK_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


class ServingFn(torch.nn.Module):
    """raw [0, 1] NHWC images -> probability maps (JAX ``make_serving_fn``):
    the ``Predictor``'s ``predict`` without the thresholds, traceable end
    to end. Holds its own copy of ``model``, cast to the model's compute
    dtype with autocast off (see the module docstring), on ``device``."""

    def __init__(self, model: torch.nn.Module, selective: bool, device=None):
        super().__init__()
        dtype = model.compute_dtype
        self.model = copy.deepcopy(model).to(device=device, dtype=dtype).eval()
        self.model.compute_dtype = torch.float32  # no autocast: the weights are in dtype
        self.dtype = dtype
        self.selective = selective

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = ((images.float() - 0.5) / 0.5).to(self.dtype).permute(0, 3, 1, 2)
        out = self.model(x)
        f, g = (out[0], out[1]) if self.selective else (out, None)
        result = {"prob": _probability(f)}
        if g is not None:
            result["selection_prob"] = _probability(g)
        return result


def _probability(logits: torch.Tensor) -> torch.Tensor:
    """sigmoid of a single-logit head, else the softmax's class-1 channel."""
    logits = logits.float()
    if logits.ndim == 3:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)[..., 1]


def make_serving_fn(model: torch.nn.Module, selective: bool, device=None) -> ServingFn:
    """The serving pipeline of ``model`` as a module (JAX
    ``make_serving_fn(model, variables, selective)``; the port's model holds
    its weights)."""
    return ServingFn(model, selective, device)


def _check_shape(batch: int, height: int, width: int) -> None:
    if height % GRID or width % GRID:
        raise ValueError(f"height/width must be multiples of {GRID} "
                         f"(the trunk max-pools 3x), got {height}x{width}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")


def _check_platforms(platforms: Sequence[str]) -> List[str]:
    platforms = list(platforms)
    if "tpu" in platforms:
        raise ValueError("the PyTorch port exports torch.export programs for 'cpu' or "
                         "'cuda'; a 'tpu' artifact is the JAX package's snet-export")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be among {list(PLATFORMS)}, got {platforms}")
    return platforms


def export_serving(predictor, batch: int, height: int, width: int, channels: int,
                   platforms: Optional[Sequence[str]] = None) -> bytes:
    """The predictor's serving pipeline for one input shape, as the bytes
    of a ``torch.export.save`` file. Its tensors live on the first of
    ``platforms`` (default: the predictor's device type)."""
    _check_shape(batch, height, width)
    platforms = _check_platforms(platforms or [predictor.device.type])
    device = (predictor.device if predictor.device.type == platforms[0]
              else torch.device(platforms[0]))
    fn = make_serving_fn(predictor.model, predictor.selective, device)
    example = torch.zeros((batch, height, width, channels), dtype=torch.float32,
                          device=device)
    with torch.no_grad():
        program = torch.export.export(fn, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(path: str, device=None):
    """The artifact as a ``torch.export.ExportedProgram``; ``.module()(images)``
    runs it. With ``device``, its tensors are moved there first."""
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return program


def write_artifact(blob: bytes, out_path: str, meta: Dict) -> List[str]:
    """Write the artifact and its JSON sidecar atomically; returns the paths."""
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, out_path)
    sidecar = out_path + ".json"
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, sidecar)
    return [out_path, sidecar]


def check_artifact(path: str, predictor, platform: str, tol: float) -> float:
    """Reload the artifact on ``platform`` and hold it against the live
    ``Predictor.predict`` on seeded images of its shape; returns the largest
    |difference| over the outputs and raises past ``tol``."""
    with open(path + ".json") as f:
        shape = json.load(f)["input_shape"]
    module = load_exported(path, platform).module()
    x = np.random.default_rng(0).random(shape, np.float32).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x).to(platform))
    want = predictor.predict(x)
    worst = 0.0
    for k in ("prob", "selection_prob"):
        if k not in want:
            continue
        err = float(np.abs(got[k].float().cpu().numpy() - want[k].astype(np.float32)).max())
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"the artifact's {k} on {platform} is {err:.3e} from the "
                                 f"live Predictor's (tolerance {tol})")
    return worst


def main(argv=None, device=None) -> Dict:
    """CLI: python -m selectivenet_for_semantic_segmentation_binary_torch.tools.export.
    The ``Predictor`` runs on ``cuda:0`` unless ``device`` names another
    device. Returns the sidecar's dict."""
    import argparse

    from ..config import check_input_channels, parse_bool

    parser = argparse.ArgumentParser(
        description="freeze the BN-folded serving forward (weights baked in) "
                    "into a portable torch.export artifact")
    parser.add_argument("--out", required=True,
                        help="artifact path (a {out}.json sidecar is written "
                             "next to it)")
    parser.add_argument("--model_path", default=None,
                        help="one specific .ckpt/.pth checkpoint")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir: the digit-latest model_epoch{N} "
                             "file is used (reference resume convention)")
    parser.add_argument("--model_arch", default="UNet_B",
                        choices=["UNet", "UNet_B"])
    parser.add_argument("--n_cls", type=int, default=2)
    parser.add_argument("--selective", type=parse_bool, default=False)
    parser.add_argument("--input_type", default="RGB", choices=["RGB", "GH"],
                        help="sets the exported channel count (RGB: 3, GH: 2) "
                             "and is recorded in the sidecar")
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--fold_bn", type=parse_bool, default=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--platforms", default=None,
                        help="comma-separated devices among 'cpu' and 'cuda'; the "
                             "artifact's tensors live on the first (default: the "
                             "device the Predictor runs on)")
    parser.add_argument("--check", type=parse_bool, default=True,
                        help="reload the written artifact and verify it reproduces "
                             "the live Predictor on every listed device present")
    a = parser.parse_args(argv)

    if a.height % GRID or a.width % GRID:
        parser.error(f"--height/--width must be multiples of {GRID}, "
                     f"got {a.height}x{a.width}")
    if a.batch < 1:
        parser.error(f"--batch must be >= 1, got {a.batch}")
    platforms = None
    if a.platforms:
        try:
            platforms = _check_platforms(p.strip() for p in a.platforms.split(",")
                                         if p.strip())
        except ValueError as e:
            parser.error(str(e))

    from ..utils.checkpoint import resolve_checkpoint

    try:
        ckpt = resolve_checkpoint(a.model_path, a.model_dir)
    except ValueError as e:
        parser.error(str(e))

    from ..predictor import Predictor

    channels = 2 if a.input_type == "GH" else 3
    predictor = Predictor(ckpt, model_arch=a.model_arch, n_cls=a.n_cls,
                          selective=a.selective, compute_dtype=a.compute_dtype,
                          fold_bn=a.fold_bn, device=device)
    check_input_channels(parser, a.input_type, predictor.in_ch)
    platforms = platforms or [predictor.device.type]
    print(f"exporting {a.model_arch} (selective={bool(a.selective)}, "
          f"{a.compute_dtype}, fold_bn={bool(a.fold_bn)}) at "
          f"({a.batch}, {a.height}, {a.width}, {channels}) "
          f"for platforms={platforms}", flush=True)
    blob = export_serving(predictor, a.batch, a.height, a.width, channels,
                          platforms=platforms)

    outputs = ["prob"] + (["selection_prob"] if a.selective else [])
    meta = {
        "artifact": "torch.export ExportedProgram",
        "calling_convention":
            "torch.export.load(path).module()(images)  # float32 [0,1] NHWC",
        "checkpoint": os.path.abspath(ckpt),
        "model_arch": a.model_arch,
        "n_cls": a.n_cls,
        "selective": bool(a.selective),
        "input_type": a.input_type,
        "compute_dtype": a.compute_dtype,
        "fold_bn": bool(a.fold_bn),
        "input_shape": [a.batch, a.height, a.width, channels],
        "input_dtype": "float32",
        "outputs": {k: [a.batch, a.height, a.width] for k in outputs},
        "platforms": platforms,
        "torch_version": torch.__version__,
        "size_bytes": len(blob),
    }
    paths = write_artifact(blob, a.out, meta)
    print(f"wrote {paths[0]} ({len(blob)/1e6:.1f} MB) + {paths[1]}", flush=True)

    if a.check:
        tol = CHECK_TOL.get(a.compute_dtype, CHECK_TOL["bfloat16"])
        for platform in platforms:
            if platform == "cuda" and not torch.cuda.is_available():
                print("check skipped on cuda: no CUDA device here", flush=True)
                continue
            err = check_artifact(a.out, predictor, platform, tol)
            print(f"check ok: the artifact reproduces the live Predictor on {platform} "
                  f"(outputs: {outputs}; max |diff| {err:.3e}, tolerance {tol})", flush=True)
    return meta


if __name__ == "__main__":
    main()
