"""Epoch checkpoints: saving, retention, auto-resume, and loading into the
port's state dict.

Counterpart of the JAX package's ``utils/checkpoint.py:46-396``. Both of its
formats load here:

* ``.pth``: a reference-format ``torch.save({"net": state_dict, ...})`` (the
  JAX package's ``export_torch_checkpoint`` writes the same), with torch
  DataParallel's ``module.`` prefix stripped (reference net_utils.py:11-16);
* ``.ckpt``: the JAX package's flax-msgpack file, decoded by the port's own
  decoder (``utils/flax_msgpack.py``; the ``msgpack`` package is not
  needed), and mapped by ``state_dict_from_jax_variables``.

The port writes ``.pth`` only, in the reference's format
``{"net", "optim", "scheduler", "epoch"}`` at
``{model_dir}/{fold}-fold/checkpoint/model_epoch{N}.pth``; the JAX package
resumes and evaluates from those files (its ``import_torch_checkpoint``).
Resume picks the newest loadable file by the digits in its name
(reference net_utils.py:18-24).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import flax_msgpack

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
    checkpoint are skipped. A BN-folded tree (JAX ``fold_batchnorm``: CBR
    scopes with a conv and no ``bn``, no ``batch_stats``) maps the same way
    onto the folded state dict of ``ops.fold_bn.fold_batchnorm``, and a
    quantized one (JAX ``quantize_folded``: ``kernel_q``, ``kernel_scale``,
    ``act_scale``, ``bias``) onto that of ``ops.quant.quantize_folded``:
    ``kernel_q`` HWIO -> OIHW, the rest as it is."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for tname, path in _TRUNK_MAP.items():
        cbr = _get(params, path)
        conv = cbr["conv"]
        if "kernel_q" in conv:  # quantized
            sd[f"{tname}.0.kernel_q"] = _tensor(np.asarray(conv["kernel_q"]).transpose(3, 2, 0, 1))
            for k in ("kernel_scale", "act_scale", "bias"):
                sd[f"{tname}.0.{k}"] = _tensor(np.asarray(conv[k], np.float32))
            continue
        sd[f"{tname}.0.weight"] = _tensor(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{tname}.0.bias"] = _tensor(conv["bias"])
        if "bn" not in cbr:  # folded
            continue
        bn = cbr["bn"]
        bs = _get(stats, path + ("bn",))
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


def act_scales_from_jax(scales: Dict[str, Any]) -> Dict[str, float]:
    """A JAX act-scale tree (``ops/quant.extract_act_scales``: ``{'trunk':
    {'enc1_1': 0.0184, ...}}``) -> the port's flat dict keyed by module
    name (``{'encoder_layer_1_1': 0.0184, ...}``)."""
    return {tname: float(_get(scales, path)) for tname, path in _TRUNK_MAP.items()
            if path[1] in scales.get(path[0], {})}


def remove_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip torch DataParallel's 'module.' prefix (net_utils.py:11-16)."""
    return {k.replace("module.", ""): v for k, v in state_dict.items()}


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a JAX-package ``.ckpt`` (flax msgpack) into numpy pytrees
    with ``flax_msgpack.unpackb``, whether or not ``msgpack`` imports."""
    with open(path, "rb") as f:
        return flax_msgpack.unpackb(f.read())


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pth`` or ``.ckpt`` file as ``{"net": the port's state dict, ...}``
    with whatever else it holds ("optim", "scheduler", "epoch"); a JAX
    ``.ckpt``'s optax state is left out (it does not fit a torch optimizer)."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if not (isinstance(ckpt, dict) and "net" in ckpt):
            ckpt = {"net": ckpt}
        net = {k: torch.as_tensor(v) for k, v in remove_module_prefix(ckpt["net"]).items()}
        return {**ckpt, "net": net}
    state = load_flax_msgpack(path)
    out = {k: v for k, v in state.items() if k not in ("net", "optim")}
    out["net"] = state_dict_from_jax_variables(state["net"])
    return out


def input_channels_of(state_dict: Dict[str, torch.Tensor]) -> int:
    """The input channels of a state dict's model: its first conv's (float
    or, in a quantized state dict, int8)."""
    w = state_dict.get("encoder_layer_1_1.0.weight")
    if w is None:
        w = state_dict["encoder_layer_1_1.0.kernel_q"]
    return int(w.shape[1])


def load_net_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a ``.pth`` or ``.ckpt`` file."""
    return load_checkpoint(path)["net"]


def resolve_checkpoint(model_path: Optional[str], model_dir: Optional[str]) -> str:
    """One checkpoint path from the ``--model_path``/``--model_dir`` pair of
    the serving CLIs (JAX ``utils/checkpoint.py:129``): exactly one of the
    two; a directory resolves to its newest ``.ckpt``/``.pth`` by the digits
    in the name (reference net_utils.py:18-24), unread, so a corrupt file
    fails loudly at load time. Raises ValueError with a CLI-ready message."""
    if (model_path is None) == (model_dir is None):
        raise ValueError("exactly one of --model_path / --model_dir is required")
    if model_path is not None:
        return model_path
    names = _by_epoch(model_dir, (".ckpt", ".pth"))
    if not names:
        raise ValueError(f"no checkpoints in {model_dir}")
    return os.path.join(model_dir, names[-1])


def _epoch_of(filename: str) -> int:
    digits = "".join(re.findall(r"\d+", filename))
    return int(digits) if digits else -1


def _by_epoch(ckpt_dir: str, suffixes) -> List[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((f for f in os.listdir(ckpt_dir) if f.endswith(suffixes)), key=_epoch_of)


def save_checkpoint(ckpt_dir: str, payload: Dict[str, Any], epoch: int) -> str:
    """``torch.save`` to ``model_epoch{epoch}.pth`` through a temporary file
    and an atomic rename, so a crash mid-write never corrupts resume."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_epoch{epoch}.pth")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` ``.pth`` files (``--keep_ckpt``;
    ``keep <= 0`` keeps every epoch, as the reference does). Unlike the JAX
    version, which prunes only its own ``.ckpt`` files and never ``.pth``,
    this prunes ``.pth``: that is the format the port writes."""
    if keep <= 0:
        return
    for name in _by_epoch(ckpt_dir, (".pth",))[:-keep]:
        os.remove(os.path.join(ckpt_dir, name))


class AsyncCheckpointWriter:
    """One-slot background checkpoint writer (``--ckpt_async 1``): the
    serialisation and the write overlap the next epoch. The payload must
    hold host copies (``train_lib`` copies every tensor to the CPU first),
    since training goes on updating the parameters in place. ``save`` joins
    the previous write first, so files land in epoch order; ``wait`` joins
    the last one and raises a stored write error."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, payload: Dict[str, Any], epoch: int, keep: int = 0) -> None:
        self.wait()

        def write():
            try:
                save_checkpoint(ckpt_dir, payload, epoch)
                prune_checkpoints(ckpt_dir, keep)
            except Exception as e:  # raised by the next save() or wait()
                self._error = e

        self._thread = threading.Thread(target=write, name=f"ckpt-epoch{epoch}", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[str, int, Dict[str, Any]]]:
    """The newest LOADABLE checkpoint as ``(path, epoch, load_checkpoint(path))``,
    or None. A newest file that cannot be read (a run killed mid-write
    before the atomic rename existed, a truncated disk) is skipped with a
    message and the next older one is tried, as in the JAX package."""
    for name in reversed(_by_epoch(ckpt_dir, (".ckpt", ".pth"))):
        path = os.path.join(ckpt_dir, name)
        try:
            return path, _epoch_of(name), load_checkpoint(path)
        except ImportError:
            raise  # a missing module is not a corrupt file
        except Exception as e:  # noqa: BLE001 - a corrupt file raises anything
            print(f"skipping unreadable checkpoint {path}: {type(e).__name__}: {e}")
    return None
