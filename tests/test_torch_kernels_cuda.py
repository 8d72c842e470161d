"""The port's CUDA eval-metrics kernel against its plain version, on a card.

Every test here needs a CUDA device and skips without one (the kernel has no
CPU mode). The file imports no JAX, so it runs on the card's machine, which
has none, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em
from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(run this file or chip_smoke.py on the card)")
    return torch.device("cuda", 0)


def _inputs(device, shape, label_dtype, seed=0):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal(shape).astype(np.float32)
    sel = rng.standard_normal(shape).astype(np.float32)
    out.reshape(-1)[::7] = 0.0  # exactly on logit(0.5)
    lab = rng.integers(0, 2, shape).astype(np.int32)
    lab.reshape(-1)[::13] = PAD_LABEL
    lab[-1] = PAD_LABEL
    return (torch.from_numpy(out).to(device), torch.from_numpy(sel).to(device),
            torch.from_numpy(lab.astype(label_dtype)).to(device))


@pytest.mark.parametrize("label_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("selective", [True, False])
@pytest.mark.parametrize("apply_sigmoid", [True, False])
@pytest.mark.parametrize("shape", [(3, 33, 47), (2, 256, 256)])
def test_kernel_equals_plain_version(cuda_device, shape, apply_sigmoid, selective,
                                     label_dtype):
    out, sel, lab = _inputs(cuda_device, shape, label_dtype)
    kw = dict(apply_sigmoid=apply_sigmoid, selective=selective, cut_off=0.3, s_cut_off=0.7)
    before = em.launches
    got = em.fused_eval_metrics(out, lab, sel if selective else None, **kw)
    want = em.eval_metrics_reference(out, lab, sel if selective else None, **kw)
    assert em.launches == before + 1
    for k in ("cm", "n_reject", "n_pix"):
        assert got[k].dtype == torch.int64
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    out, sel, lab = _inputs(cuda_device, (2, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        em.fused_eval_metrics(out.transpose(1, 2), lab.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        em.fused_eval_metrics(out.half(), lab)
    with pytest.raises(ValueError, match="uint8 or int32"):
        em.fused_eval_metrics(out, lab.long())
    with pytest.raises(ValueError, match="selection"):
        em.fused_eval_metrics(out, lab, None, selective=True)
    with pytest.raises(ValueError, match="is on"):
        em.fused_eval_metrics(out, lab.cpu())
