"""Checkpoint discovery and loading into the port's state dict.

Counterpart of the JAX package's ``utils/checkpoint.py:235-396``. Both of its
formats load here:

* ``.pth``: a reference-format ``torch.save({"net": state_dict})`` (the
  JAX package's ``export_torch_checkpoint`` writes the same), with torch
  DataParallel's ``module.`` prefix stripped (reference net_utils.py:11-16);
* ``.ckpt``: the JAX package's flax-msgpack file, decoded here by hand with
  ``msgpack`` (imported on use) and mapped by ``state_dict_from_jax_variables``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

# reference torch module name -> flax scope path (JAX models/unet.py)
_TRUNK_MAP = {
    "encoder_layer_1_1": ("trunk", "enc1_1"),
    "encoder_layer_1_2": ("trunk", "enc1_2"),
    "encoder_layer_2_1": ("trunk", "enc2_1"),
    "encoder_layer_2_2": ("trunk", "enc2_2"),
    "encoder_layer_3_1": ("trunk", "enc3_1"),
    "encoder_layer_3_2": ("trunk", "enc3_2"),
    "decoder_layer_4_2": ("trunk", "dec4_2"),
    "decoder_layer_4_1": ("trunk", "dec4_1"),
    "decoder_layer_3_2": ("trunk", "dec3_2"),
    "decoder_layer_3_1": ("trunk", "dec3_1"),
    "decoder_layer_2_2": ("trunk", "dec2_2"),
    "decoder_layer_2_1": ("trunk", "dec2_1"),
    "decoder_layer_1_2": ("trunk", "dec1_2"),
    "decoder_layer_1_1": ("trunk", "dec1_1"),
}
_UPCONV_MAP = {name: ("trunk", name) for name in ("unpool3", "unpool2", "unpool1")}
_HEAD_NAMES = ("conv1x1", "conv_select", "conv_aux")

# flax msgpack ext type codes (flax.serialization._MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def list_checkpoints(ckpt_dir: str) -> List[str]:
    """All .ckpt/.pth files in ``ckpt_dir``, sorted by name (reference
    eval.py:116 discovers every checkpoint in the directory)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                  if f.endswith((".ckpt", ".pth")))


def _get(tree: dict, path) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _tensor(a) -> torch.Tensor:
    # a C-ordered, writable copy: decoded buffers are read-only views
    return torch.from_numpy(np.array(a, order="C"))


def state_dict_from_jax_variables(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map numpy ``{"params", "batch_stats"}`` (JAX layout) to the port's
    state dict: conv kernels HWIO -> OIHW; transposed-conv kernels
    (kh, kw, in, out) -> (in, out, kh, kw) with the spatial taps flipped
    (JAX checkpoint.py:309-312, 362-366); BN scale/bias/mean/var ->
    weight/bias/running_mean/running_var. Heads absent from a non-selective
    checkpoint are skipped."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for tname, path in _TRUNK_MAP.items():
        conv = _get(params, path + ("conv",))
        bn = _get(params, path + ("bn",))
        bs = _get(stats, path + ("bn",))
        sd[f"{tname}.0.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{tname}.0.bias"] = _tensor(conv["bias"])
        sd[f"{tname}.1.weight"] = _tensor(bn["scale"])
        sd[f"{tname}.1.bias"] = _tensor(bn["bias"])
        sd[f"{tname}.1.running_mean"] = _tensor(bs["mean"])
        sd[f"{tname}.1.running_var"] = _tensor(bs["var"])
    for tname, path in _UPCONV_MAP.items():
        convt = _get(params, path + ("convt",))
        k = np.asarray(convt["kernel"])[::-1, ::-1]
        sd[f"{tname}.weight"] = _tensor(k.transpose(2, 3, 0, 1))
        sd[f"{tname}.bias"] = _tensor(convt["bias"])
    for tname in _HEAD_NAMES:
        if tname not in params:
            continue
        conv = params[tname]["conv"]
        sd[f"{tname}.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{tname}.bias"] = _tensor(conv["bias"])
    return sd


def _msgpack_ext(code: int, data: bytes):
    import msgpack

    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a JAX-package ``.ckpt`` (flax msgpack) into numpy pytrees."""
    import msgpack

    with open(path, "rb") as f:
        state = msgpack.unpackb(f.read(), ext_hook=_msgpack_ext, raw=False)
    return state


def load_net_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a ``.pth`` or ``.ckpt`` file."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        net = ckpt["net"] if isinstance(ckpt, dict) and "net" in ckpt else ckpt
        return {k.replace("module.", ""): torch.as_tensor(v) for k, v in net.items()}
    return state_dict_from_jax_variables(load_flax_msgpack(path)["net"])
