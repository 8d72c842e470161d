"""Checkpoint inspection tool (``snet-inspect-ckpt``; reference
jupyters/check_net.ipynb cells 0-7).

Counterpart of the JAX package's ``tools/inspect_ckpt.py:39-153``: the same
``summarize`` and ``compare`` dicts and the same printed lines, for both
checkpoint formats:

* a JAX ``model_epoch{N}.ckpt`` (flax msgpack of the full train state),
  decoded by the port's own ``utils/flax_msgpack.py`` (``msgpack`` is not
  needed) and canonicalised by ``utils/checkpoint.state_dict_from_jax_variables``;
* a reference or port ``model_epoch{N}.pth`` (torch ``{'net': state_dict,
  ...}``), read with ``torch.load(..., weights_only=True)``.

``compare`` is the notebook's DataParallel-vs-bare interchange check made
exact: a canonical key/shape diff in the reference's layer names
(model.py:19-66). A ``.pth`` written by ``torch`` carries the BatchNorms'
``num_batches_tracked`` counters, which a JAX ``.ckpt`` has no counterpart
of: they show up in ``only_in_a``/``only_in_b``, as in the JAX tool.

Usage::

    python -m selectivenet_for_semantic_segmentation_binary_torch.tools.inspect_ckpt \\
        /model/1-fold/checkpoint/model_epoch200.pth [--keys] [--compare OTHER.ckpt]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from ..utils.checkpoint import (_epoch_of, load_flax_msgpack, load_net_checkpoint,
                                remove_module_prefix)

_SELECTIVE_HEADS = ("conv_select", "conv_aux")


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict pytree into {'a/b/c': leaf} (numpy leaves)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _load_torch(path: str) -> Any:
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy_net(net: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in net.items()}


def canonical_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Either format -> reference-named (model.py) state dict, module.-stripped."""
    return _numpy_net(load_net_checkpoint(path))


def summarize(path: str) -> Dict[str, Any]:
    """Structured summary of one checkpoint (either format)."""
    info: Dict[str, Any] = {
        "path": path,
        "format": "torch" if path.endswith(".pth") else "native",
        "epoch_from_name": _epoch_of(path.rsplit("/", 1)[-1]),
    }
    if info["format"] == "torch":
        ckpt = _load_torch(path)
        if isinstance(ckpt, dict) and "net" in ckpt:
            info["payload_keys"] = sorted(ckpt.keys())
            raw = _numpy_net(ckpt["net"])
        else:
            info["payload_keys"] = ["<bare state_dict>"]
            raw = _numpy_net(ckpt)
        info["dataparallel_prefix"] = any(k.startswith("module.") for k in raw)
        sd = remove_module_prefix(raw)
    else:
        state = load_flax_msgpack(path)
        info["payload_keys"] = sorted(state.keys())
        info["epoch_stored"] = state.get("epoch")
        info["dataparallel_prefix"] = False  # never written by either package
        sd = _flatten(state["net"])
    info["n_tensors"] = len(sd)
    info["n_params"] = int(sum(v.size for v in sd.values()))
    info["selective"] = any(h in k for k in sd for h in _SELECTIVE_HEADS)
    info["tensors"] = {k: (tuple(v.shape), str(v.dtype)) for k, v in sorted(sd.items())}
    return info


def compare(path_a: str, path_b: str) -> Dict[str, Any]:
    """Canonical key/shape diff between two checkpoints of either format: a
    torch DataParallel checkpoint and a JAX one of the same architecture
    report empty ``shape_mismatch`` and differ only by the BatchNorm
    counters (see the module docstring)."""
    a, b = canonical_state_dict(path_a), canonical_state_dict(path_b)
    shared = sorted(a.keys() & b.keys())
    return {
        "only_in_a": sorted(a.keys() - b.keys()),
        "only_in_b": sorted(b.keys() - a.keys()),
        "shape_mismatch": {
            k: (tuple(a[k].shape), tuple(b[k].shape))
            for k in shared
            if a[k].shape != b[k].shape
        },
        "n_shared": len(shared),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("path", help=".ckpt (native) or .pth (reference) checkpoint")
    p.add_argument("--keys", action="store_true", help="print every tensor key/shape/dtype")
    p.add_argument("--compare", default=None, help="second checkpoint to key/shape-diff against")
    args = p.parse_args(argv)

    info = summarize(args.path)
    print(f"{info['path']}")
    print(f"  format: {info['format']}, payload keys: {info['payload_keys']}")
    epoch = info.get("epoch_stored", info["epoch_from_name"])
    print(f"  epoch: {epoch}")
    print(f"  tensors: {info['n_tensors']}, parameters: {info['n_params']:,}")
    print(f"  selective heads: {info['selective']}, "
          f"DataParallel 'module.' prefix: {info['dataparallel_prefix']}")
    if args.keys:
        for k, (shape, dtype) in info["tensors"].items():
            print(f"    {k}  {shape}  {dtype}")

    if args.compare:
        d = compare(args.path, args.compare)
        print(f"vs {args.compare}  (canonical reference naming)")
        print(f"  shared tensors: {d['n_shared']}")
        for label in ("only_in_a", "only_in_b"):
            if d[label]:
                print(f"  {label}: {d[label]}")
        if d["shape_mismatch"]:
            for k, (sa, sb) in d["shape_mismatch"].items():
                print(f"  shape mismatch {k}: {sa} vs {sb}")
        if not d["only_in_a"] and not d["only_in_b"] and not d["shape_mismatch"]:
            print("  MATCH: identical key sets and shapes")


if __name__ == "__main__":
    main()
