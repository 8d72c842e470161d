"""The port loads both checkpoint formats of the JAX package.

A JAX ``save_checkpoint`` ``.ckpt`` (flax msgpack, decoded by hand in the
port) and an ``export_torch_checkpoint`` ``.pth`` of the same variables must
load to identical arrays, equal to the JAX package's own torch export.
"""

import os

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_tpu.utils.checkpoint import (
    export_torch_checkpoint,
    save_checkpoint,
    torch_state_dict_to_variables,
    variables_to_torch_state_dict,
)
from selectivenet_for_semantic_segmentation_binary_torch.models import build_model, load_weights
from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
    list_checkpoints,
    load_net_checkpoint,
)


@pytest.fixture(scope="module", params=[True, False], ids=["selective", "plain"])
def variables(request):
    """Seeded UNet_B variables in the JAX layout (made from a port model
    through the JAX package's importer; no flax init, which costs seconds)."""
    torch.manual_seed(3)
    sd = build_model("UNet_B", selective=request.param).state_dict()
    sd = {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return torch_state_dict_to_variables(sd), request.param


def test_ckpt_and_pth_load_to_identical_arrays(variables, tmp_path):
    v, selective = variables
    ckpt = save_checkpoint(str(tmp_path), {"net": v, "epoch": 7}, epoch=7)
    pth = export_torch_checkpoint(v, str(tmp_path / "model_epoch8.pth"))
    from_ckpt = load_net_checkpoint(ckpt)
    from_pth = load_net_checkpoint(pth)
    want = variables_to_torch_state_dict(v)
    assert sorted(from_ckpt) == sorted(from_pth) == sorted(want)
    for k in want:
        assert from_ckpt[k].dtype == torch.float32
        assert torch.equal(from_ckpt[k], from_pth[k]), k
        np.testing.assert_array_equal(from_ckpt[k].numpy(), want[k], err_msg=k)
    assert ("conv_select.weight" in want) == selective
    # and the weights fit the port's model of the same kind
    load_weights(build_model("UNet_B", selective=selective), from_ckpt)
    assert list_checkpoints(str(tmp_path)) == [ckpt, pth]


def test_reference_pth_with_dataparallel_prefix(tmp_path):
    """A reference-format .pth: torch DataParallel's ``module.`` prefix and
    BN ``num_batches_tracked`` counters, as the reference's net_save writes."""
    torch.manual_seed(0)
    model = build_model("UNet_B", selective=True)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    path = str(tmp_path / "model_epoch3.pth")
    torch.save({"net": sd, "optim": {"state": {}, "param_groups": []}}, path)
    loaded = load_net_checkpoint(path)
    assert sorted(loaded) == sorted(model.state_dict())
    fresh = build_model("UNet_B", selective=True)
    load_weights(fresh, loaded)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_list_checkpoints_ignores_other_files(tmp_path):
    for name in ("b.pth", "a.ckpt", "notes.txt", "c.ckpt.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert list_checkpoints(str(tmp_path)) == [
        os.path.join(str(tmp_path), "a.ckpt"), os.path.join(str(tmp_path), "b.pth")]
    assert list_checkpoints(str(tmp_path / "missing")) == []
