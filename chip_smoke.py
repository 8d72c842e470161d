#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py [--against OTHER_KERNELS_DIR]

``--against`` names another commit's ``kernels/`` directory (unpacked with
``git archive``): phases 5, 12, 15 and 20 then also time K1, K3, K6 (v1 and
v2), K9 and K10 against that build of them, in turns (other, this, this,
other).

It drives the port's two slices on the full-width selective UNet_B, the
in-coverage evaluation (``eval_lib.evaluate``, the path of ``eval.py
--model_arch UNet_B --selective 1 --select_eval 1``) and the training
(``train_lib.train``, the path of ``train.sh``: BCElogit selective risk,
Adam, batch 128, 256x256, bfloat16, with ``--fused_cbr on``), then the
prototype kernels through their entry points (``..._torch/scripts/
proto_{fused_cbr,pallas_dw,bn_stats,transposed_cbr}.py`` and
``bisect_transposed{,2,3}.py``, the counterparts of the JAX package's Pallas
prototypes in ``scripts/``), then the serving path (``Predictor``,
``predict_wsi``, ``PredictionService`` and its HTTP server), then the
analysis path (``snet-wsi``, ``snet-calibrate``, MC-dropout and training
with dropout), then the host input pipelines (GH and H_RGB stain inputs,
blank-field correction, PNT, ``--device_preproc 0``, the native decoder),
then the tools and the single-card train variants (``snet-split``,
``snet-sweep``, ``snet-inspect-ckpt``, ``snet-export``, the TensorBoard
reader, ``--remat``, ``--bn_stats bfloat16``, ``--profile_dir`` and the
port's bench), then the int8 path (W8A8 serving through the ``Predictor``,
``snet-predict``, ``snet-wsi``, ``snet-eval`` and ``snet-serve``, and QAT,
on the int8 conv kernel K10), and exits non-zero at the first failure.
Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the seven sources ``kernels/{eval_metrics,
   fused_conv_stats,conv_dw,bn_stats,transposed_cbr,transposed_bisect,
   int8_conv}.cu`` from the checkout, one nvcc each, started together;
3. the kernel against its plain version, integer for integer, over shapes,
   modes, cut-offs, label types, padding, logits on the cut-off, a count
   above 2^24, misaligned views (the element path) and a batch of padding
   only, one launch a call; each case's path is printed;
4. the slice: a seeded random UNet_B saved as ``.pth``, 2x128+37 in-memory
   uint8 patches of 256x256 through the port's PatchLoader and evaluate()
   in bfloat16 at batch 128; the kernel's launch counter must count one
   launch a batch, the metrics must be finite, and evaluate()'s counts must
   equal the plain version's on the logits of evaluate()'s own forwards;
   the float32 forward on the card must match the CPU's on a small input;
5. timings (median of >= 20 runs after warm-up): the eval step, the forward
   alone, the kernel against its plain version; with ``--against``, the
   kernel against the other build's in turns;
6. the fused-CBR kernel against its plain version in bf16, at every
   distinct (Cin, Cout, HxW) of its 13 layers at 256x256, at batch 2 and at
   the main path's batch 128 (tiles of 8 samples: every tile past sample 0
   too), at N = 16 and a ragged N = 19 at both tile widths and one ragged
   image, prologue on and off, with a nonzero prologue shift (the halo),
   and two shapes at a = 0, b > 0 in every other channel; y, stats,
   run-to-run identity, and gradients through its autograd.Function
   against autograd of the plain version;
7. the training slice: ``train()`` for one epoch on 4x128 seeded in-memory
   training patches and 128+37 validation patches (the last batch padded);
   the kernel's launch counter must read 13 per batch, train and valid;
   the losses must be finite, the selection loss >= 0; the ``.pth`` must be
   written; a second call must resume at epoch 2 (``--keep_ckpt 1``); the
   eval slice's ``evaluate()`` must load and score the trained file; one
   train step with the fused and one with the classic trunk, from the same
   weights and batch, must agree on the loss; one more step of each runs
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
8. timings: the train step and the forward with the fused and the classic
   trunk, and each of the 13 kernel layers against its plain version at
   batch 128, beside the cuDNN conv alone at that shape and the bound;
9. the staged-band fused CBR (K3, ``fused_cbr_rows``, on the band kernel of
   ``fused_conv_stats.cu``) as phase 6 holds ``fused_conv_stats``: at the
   (H, W, Cin, Cout, rows) of each of its script's 12 shapes (batch 2) and
   two ragged shapes (one at Cin = 32, a last chunk of 32 channels),
   prologue on and off, a nonzero prologue shift, against the exact
   reference and the plain version, run to run identical;
10. the dW kernel (``conv_dw``) against float64 of the same operands and the
   plain version (cuDNN): bf16 at its script's 8 shapes (batch 8), the
   script's 4 check shapes and a ragged one in bf16 and float32, both
   variants, run to run identical;
11. the BN-statistics kernel (``bn_stats``) against float64 sums and the
   plain version at its script's (128, 256, 256, 64), a row count whose
   tail the TPU grid would drop and an odd one, run to run identical;
12. the three entry points' ``bench`` functions (and the dW ``check``), the
   launch counters set to 0 before and read after: every shape of each
   script at batch 128, kernel against plain version, device time (median
   of 20 after warm-up); with ``--against``, K3 against the other build's,
   in turns (those launches are not counted);
13. the transposed fused-CBR kernel (``transposed_cbr``), v1 and v2, as
   phase 6 holds ``fused_conv_stats``: at its script's check shape (N=8,
   32x32, 64->64), at N=128, 32x32 for every channel width of UNet_B and
   512->256, at N = 64, 104 (a partial 64-sample block) and 136, at Cin = 32
   and 96 (a last chunk of 32 channels), W = 11 and H = 1, and at N = 3,
   100 and 130 (N % 8 != 0: the element-by-element copy), prologue on and
   off, run to run identical, each case's path printed; v1 and v2 equal bit for bit, also with a
   channel at a=0, b>0, whose border the JAX v2 gets wrong;
14. every K7/K8/K9 bisection kernel (``transposed_bisect``) against its
   plain version through its script's comparison, on ones and on a seeded
   input, at H=W=64 and at small shapes: N=3 (the element path), C=72 (a
   ragged channel tile), W*N=168 (a ragged column tile) and C=256 (K7's and
   K8's tile design; K9's chunk ring: its stats held to a float64 sum of its
   own y, its y to the plain version's within one bf16 ulp); each case's
   line names the path its kernel took (phase 15 runs the scripts' own
   size);
15. the four entry points ``proto_transposed_cbr`` (check and bench at the
   level-1 shape) and ``bisect_transposed{,2,3}`` (timed, each case against
   its plain version and its one PyTorch call), the launch counters set to
   0 before and read after; with ``--against``, K6 v1 and v2 against the
   other build's inside ``proto_transposed_cbr``'s bench (beside the cuDNN
   conv alone and the bound) and then K9 (``bisect_against``), in turns;
16. the serving path (no kernel of its own: cuDNN convs and plain PyTorch,
   as the JAX Predictor's XLA graph): a seeded selective UNet_B with BN
   statistics away from the identity saved as ``.pth``; the bf16
   ``Predictor`` folded and unfolded against the float32 unfolded forward
   on the card at batch 128 (logits, flipped mask pixels);
   ``predict_compact`` against ``predict`` (masks bit-equal, ``prob_u8``
   within 1 of round(prob * 255)); ``predict_wsi`` of a 2048x2048 uint8
   slide (tile 512, batch 8), float32 and bf16, against the float32
   whole-image forward; ``PredictionService(max_batch=8)`` under 8 client
   threads x 4 requests of off-grid sizes in uint8 and float32, each answer
   held to ``predict`` of its image alone, fewer batches than requests, no
   error; ``make_server`` on 127.0.0.1 (``/healthz`` says cuda, a PNG
   POSTed where Pillow imports, ``/info`` and ``/metrics`` agree, a clean
   shutdown); times: the folded and unfolded forward (device), ``predict``
   and ``predict_compact`` (host wall), one request alone through the
   service (p50) and the service's throughput under 8 clients;
17. the analysis path (K2 on its training part; K2's counter set to 0 at
   its start and read at its end): a seeded selective UNet_B with BN
   statistics away from the identity saved as ``.pth``, bf16; a synthetic
   JPEG/PNG tree (``tools/synthetic.write_synthetic_patch_tree``, 78 slides
   of 18 patches of 256x256) whose fold lists are dealt again so that test
   fold 1 holds four whole slides; ``cli.main(["wsi", ...])`` with
   ``--nrow 3``: each stitched probability within 3e-2 of the float32
   forward on the card, mask flips only within 3e-2 of the cut-off, every
   score equal to a float64 recomputation (AUC by the rank formula) within
   1e-12, the CSV and PNGs; ``cli.main(["calibrate", ..., "--split",
   "valid", "--curve_csv", ...])`` at batch 128: the histograms' totals
   equal the split's pixels, the 1-D histogram the 2-D one's marginal, the
   coverage the request within one bin, the threshold that of a sort of g
   within 1/4096; MC-dropout through the ``Predictor``: rate 0 gives
   variance 0 and ``predict``'s probability, rate 0.1 (32 forwards) a
   variance above 0, the same maps for the same seed and others for
   another, a kept fraction within 0.5% of 0.9 at both sites (forward
   hooks); ``snet-predict --uncertainty 8`` writes its ``.npz`` and PNG; a
   train step at batch 128 with ``--dropout_rate 0.1`` on both trunks
   (finite loss, 13 K2 launches a fused step, no host sync); times:
   ``snet-wsi`` a slide (first and second call) with its forward and its
   scoring, ``snet-calibrate``'s wall, ``mc_uncertainty`` a stochastic
   forward at batch 8 and 128 beside ``predict_compact``, the train step
   with and without dropout on both trunks;
18. the input pipelines (K1 and K2 on it; their counters set to 0 at its
   start, K2's read right after ``train()`` and K1's right after
   ``evaluate()``): a JPEG/PNG tree of 50 slides x 16 patches of 256x256
   (``tools/synthetic.write_synthetic_patch_tree``; fold 1 trains on 4
   batches of 128); whether the native build of ``native/patch_decoder.cpp``
   succeeded (else the compiler's last line); the train feed alone (``train_lib.make_loaders``, 16 workers, one epoch into
   the card, no step, after an untimed warm-up, decoding with PIL, the
   default) for RGB raw, RGB ``--device_preproc 0``, ``--blankfield 1`` and
   ``--pnt_aug 1``, GH, GH with blank-field and H_RGB, and RGB raw with the
   native decoder where it builds (skipped, with the compiler's last error
   line, where it does not); ``train()``
   with ``--input_type GH --blankfield 1 --fused_cbr on`` for one epoch (13
   K2 launches a batch, finite losses, a 2-channel first conv) and one GH
   step of the fused trunk against the classic one within phase 7's 1e-2;
   the train pass of an epoch, GH and RGB raw in turns (GH, RGB, RGB, GH),
   with its patches/s and the card's busy share (kernel time from
   ``torch.profiler`` over the pass's wall); ``evaluate()`` with
   ``--input_type GH --blankfield 1 --select_eval 1`` on the checkpoint at
   the ``--s_cut_off`` that ``snet-calibrate`` (same flags, the validation
   split) printed (one K1 launch a batch, its counts equal to the plain
   version's on evaluate()'s own logits, a finite accuracy, a rejection
   ratio in (0, 1)); ``snet-predict`` (within 3e-2 of the float32 forward)
   and ``snet-wsi`` of one slide, each with ``--input_type GH --blankfield
   1`` on that checkpoint; the three CLIs' walls; whether ``msgpack`` imports, and the committed JAX
   ``.ckpt`` fixture (``tests/data/jax_fixture.ckpt``) decoded to its
   ``.npz`` by the port's own decoder;
19. the tools and the train variants at full width (K1 and K2 on its
   sweep; their counters set to 0 just before ``run_sweep`` and read just
   after): a hard synthetic tree
   (``tools/synthetic.write_hard_synthetic_patch_tree``, 6 slides x 16
   patches of 256x256) whose fold lists ``snet-split``'s
   ``build_fold_lists`` rebuilds with the writer's classes and fold sizes;
   ``run_sweep`` of one variant and fold, 2 epochs at batch 16 with
   ``--fused_cbr on`` (13 K2 launches a batch, one K1 launch an eval
   batch, counted exactly), then the same cell with ``isolate_cells=True``
   in a child process on the card (the CSVs equal in header and text, the
   numbers within 1e-2); ``read_scalars`` finds every epoch's train and
   valid loss; ``inspect_ckpt.compare`` MATCH between the two cells'
   ``.pth`` and the reason the JAX fixture has no canonical names;
   ``snet-export --check 1`` at (8, 256, 256, 3) within 3e-2 of the live
   ``Predictor``, and the batch-128 artifact's forward against the
   Predictor's (device medians, in turns); one ``--remat`` step at batch
   128, classic and fused, against the plain step from the same weights
   and batch (loss, BN running statistics, each parameter's gradient
   norm-wise and the second step's loss within 1e-3 relative; 26 K2
   launches a fused remat step, 13 of them in the recompute), with peak
   memory and ms; one classic ``--bn_stats bfloat16`` step within 1e-2 of
   the float32 one, and the fused trunk refusing it; ``train()`` with
   ``--profile_dir`` leaving a trace that names ``fused_conv_stats``; the
   port's bench (``python -m ..._torch.bench``) in a subprocess, its JSON
   line printed on a line of its own;
20. the int8 path at full width (K10's counter set to 0 before the first
   int8 ``Predictor`` and read after the QAT step; K1's around each
   ``snet-eval``): K10 against its plain version bit for bit at the 14
   trunk shapes of UNet_B at batch 128, both epilogues (static: bias and
   ReLU; dynamic: the QAT product), bf16 and float32 inputs, and the first
   layer at Cin 2 and 3; ``kernel_path`` naming the wgmma kernel for the 13
   layers with Cin >= 64 at batch 128 and the im2col kernel for the first;
   the int8 ``Predictor`` at batch 128, calibrated on the batch, for two
   checkpoints (the JAX tests' model, torch's default init; phase 16's
   seeded model): 14 K10 launches a forward, every output
   equal to the plain version's swapped in, and the distance to the bf16
   folded ``Predictor`` (held to the JAX tests' bounds, max |prob diff| <
   0.01 and > 99% equal masks, on the JAX tests' model; printed on the
   seeded one, which the JAX package's int8 trunk misses as much);
   ``snet-predict --quantize int8 --calib_images`` equal to the
   ``Predictor`` calibrated on the same image; ``snet-wsi --quantize int8``
   on a one-slide test fold of phase 17's writer; ``snet-eval --quantize
   int8`` on both models (accuracy within the JAX tests' 0.02 of bf16 on the
   JAX tests' model; K1 launches); a classic train step with
   ``--train_quant int8`` against the float one from the same weights and
   batch on both models (loss differing by more than 0 and, on the JAX
   tests' model, by less than 5e-2 relative, gradients' cosine > 0.8; 14
   K10 launches a step); ``snet-serve --quantize int8 --calib_images`` in
   its own process (``/healthz`` names the trunk, two POSTed PNGs answered
   as the ``Predictor`` answers, SIGTERM, exit 0); times: the int8 folded
   forward against the bf16 one in turns, ``predict_compact``, the
   calibration wall, the QAT step against the classic one, and K10 over the
   14 layers, each layer's time, TOP/s, path and bound (int8 operations at
   1,979 TOP/s), against its plain version, cuDNN's bf16 conv alone of the
   same layers and ``torch._int_mm`` of one layer's im2col matrix; with
   ``--against``, K10 against the other build's, layer by layer in turns
   (``scripts/int8_conv_against.py``).

Every kernel's record gives its time, its plain version's, the least time
the card could take for the same work (``bound_ms``: bytes over 3.35 TB/s
or bf16 operations over 989 TFLOP/s, whichever is larger, from this run's
shapes) and, where one PyTorch call computes the same function, that call's
time (``library_ms``; else null). For the bisection kernels K7-K9, whose
scripts time each case against the one call where it has one,
``library_ms`` is summed over those cases, beside their count
(``one_call_cases``) and the kernel's ms on them (``ms_on_one_call_cases``).
K2's record also gives ``launches_analysis``, its launches in phase 17,
K1's and K2's ``launches_inputs``, their launches in phase 18's
``evaluate()`` and ``train()``, and ``launches_tools``, their launches in
phase 19's ``run_sweep``; K1's ``launches_int8``, its launches in phase 20's
int8 ``snet-eval``. K10's record (``int8_conv``; it replaces the XLA int8
conv of the JAX package's W8A8 CBR, no Pallas kernel) has ``library_ms``
null (no PyTorch call computes an int8 conv) and gives ``cudnn_bf16_ms``,
``int_mm_one_layer_ms`` and ``k10_one_layer_ms`` beside it; its bound is
taken at the int8 rate.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it raises at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 128
SIZE = 256
N_PATCHES = 2 * BATCH + 37
WARMUP = 3
RUNS = 20
KERNEL_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/eval_metrics.cu"
TPU_KERNEL = "selectivenet_for_semantic_segmentation_binary_tpu/ops/pallas_metrics.py:44"
CBR_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/fused_conv_stats.cu"
CBR_TPU_KERNEL = "selectivenet_for_semantic_segmentation_binary_tpu/ops/fused_cbr.py:98"
N_TRAIN = 4 * BATCH
N_VALID = BATCH + 37
TRAIN_RUNS = 8
ROWS_SOURCE = CBR_SOURCE  # K3 runs on K2's band kernel
ROWS_TPU_KERNEL = "scripts/proto_fused_cbr.py:42"
DW_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/conv_dw.cu"
DW_TPU_KERNEL = "scripts/proto_pallas_dw.py:54"
BN_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/bn_stats.cu"
BN_TPU_KERNEL = "scripts/proto_bn_stats.py:32"
TC_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/transposed_cbr.cu"
TC_TPU_KERNEL = {"v1": "scripts/proto_transposed_cbr.py:49",
                 "v2": "scripts/proto_transposed_cbr.py:181"}
TB_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/transposed_bisect.cu"
# K10 has no Pallas original: it replaces the XLA int8 conv of the W8A8 CBR
INT8_SOURCE = "selectivenet_for_semantic_segmentation_binary_torch/kernels/int8_conv.cu"
INT8_TPU_KERNEL = "selectivenet_for_semantic_segmentation_binary_tpu/models/unet.py:322"
TB_TPU_KERNEL = {"K7": "scripts/bisect_transposed.py:29", "K8": "scripts/bisect_transposed2.py:15",
                 "K9": "scripts/bisect_transposed3.py:18"}
# phase 14's shapes (N, H, W, C): 64x64 at the scripts' N and C; N = 3 (the
# element path); C = 72 (a ragged channel tile of the dots); W*N = 168 (a
# ragged column tile); C = 256 (K7's and K8's tile design, the window does
# not fit; K9's 768-term dots through its chunk ring)
BISECT_SHAPES = ((128, 64, 64, 64), (3, 6, 20, 64), (16, 6, 20, 72), (24, 5, 7, 64),
                 (16, 4, 12, 256))
# conv_dw's tolerances, relative to max |dW| (tests/test_torch_kernels_cuda.py)
DW_EXACT_TOL = {"bfloat16": 1e-4, "float32": 2e-6}
DW_PLAIN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def max_count_err(a, b) -> int:
    return max(int((a[k].long() - b[k].long()).abs().max())
               for k in ("cm", "n_reject", "n_pix"))


def same_counts(a, b) -> bool:
    return max_count_err(a, b) == 0


def phase_kernel_exact(torch, em, device) -> int:
    """Phase 3. Returns the largest count difference seen (must be 0)."""
    from selectivenet_for_semantic_segmentation_binary_torch.ops.confusion import PAD_LABEL

    g = torch.Generator(device=device).manual_seed(SEED)
    worst = 0
    n_cases = 0
    for shape in ((128, 256, 256), (3, 33, 47)):
        for apply_sigmoid in (True, False):
            for selective in (True, False):
                for cut, s_cut in ((0.5, 0.5), (0.3, 0.7)):
                    for label_dtype in (torch.uint8, torch.int32):
                        if apply_sigmoid:
                            out = torch.randn(shape, generator=g, device=device)
                            sel = torch.randn(shape, generator=g, device=device)
                            on_cut = math.log(cut / (1.0 - cut))
                            on_s_cut = math.log(s_cut / (1.0 - s_cut))
                        else:
                            out = torch.rand(shape, generator=g, device=device)
                            sel = torch.rand(shape, generator=g, device=device)
                            on_cut, on_s_cut = cut, s_cut
                        # every 7th logit exactly on the cut-off (in float32)
                        out.view(-1)[::7] = on_cut
                        sel.view(-1)[::5] = on_s_cut
                        lab = torch.randint(0, 2, shape, generator=g, device=device,
                                            dtype=torch.int32)
                        lab.view(-1)[::97] = PAD_LABEL
                        if label_dtype == torch.int32:
                            lab.view(-1)[::89] = -1
                        lab[-1] = PAD_LABEL  # one fully padded sample
                        lab = lab.to(label_dtype)
                        kw = dict(apply_sigmoid=apply_sigmoid, selective=selective,
                                  cut_off=cut, s_cut_off=s_cut)
                        got = em.fused_eval_metrics(out, lab, sel if selective else None, **kw)
                        want = em.eval_metrics_reference(out, lab, sel if selective else None, **kw)
                        torch.cuda.synchronize()
                        err = max_count_err(got, want)
                        worst = max(worst, err)
                        n_cases += 1
                        if err:
                            raise AssertionError(
                                f"kernel != plain for shape={shape} sigmoid={apply_sigmoid} "
                                f"selective={selective} cut={cut}/{s_cut} "
                                f"label={label_dtype}: {got} vs {want}")
    # misaligned views (the element path), n not a multiple of 16, int32
    # labels, a batch of padding only; each call one launch
    paths = set()
    for shape, label_dtype, pad_only in (((3, 33, 47), torch.uint8, False),
                                         ((2, 256, 256), torch.int32, False),
                                         ((2, 64, 64), torch.uint8, True)):
        out = torch.randn(shape, generator=g, device=device)
        sel = torch.randn(shape, generator=g, device=device)
        lab = torch.randint(0, 2, shape, generator=g, device=device, dtype=torch.int32)
        if pad_only:
            lab.fill_(PAD_LABEL)
        lab = lab.to(label_dtype)
        for tensors in ((out, lab, sel), tuple(t.view(-1)[1:] for t in (out, lab, sel))):
            kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
            before = em.launches
            got = em.fused_eval_metrics(*tensors, **kw)
            want = em.eval_metrics_reference(*tensors, **kw)
            torch.cuda.synchronize()
            path = em.kernel_path(tensors[0], tensors[1], tensors[2])
            paths.add(path)
            err = max_count_err(got, want)
            worst = max(worst, err)
            n_cases += 1
            if err or em.launches != before + 1 or (pad_only and int(got["n_pix"]) != 0):
                raise AssertionError(f"kernel != plain on the {path} path at {shape} "
                                     f"{label_dtype} (padding only {pad_only}): {got} vs {want}")
    print(f"[phase 3] paths taken: {', '.join(sorted(paths))}")
    # a count above 2^24: exact only with integer accumulation
    shape = (260, 256, 256)
    out = torch.rand(shape, generator=g, device=device) + 0.01
    sel = torch.rand(shape, generator=g, device=device) + 0.01
    lab = torch.ones(shape, dtype=torch.uint8, device=device)
    kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
    got = em.fused_eval_metrics(out, lab, sel, **kw)
    want = em.eval_metrics_reference(out, lab, sel, **kw)
    torch.cuda.synchronize()
    big = 260 * 256 * 256
    if int(got["cm"][1, 1]) != big or big != 17_039_360 or not same_counts(got, want):
        raise AssertionError(f"count above 2^24 wrong: cm={got['cm'].tolist()} "
                             f"want cm[1,1]={big}; plain {want['cm'].tolist()}")
    worst = max(worst, max_count_err(got, want))
    n_cases += 1
    print(f"[phase 3] kernel == plain version, integer for integer, in {n_cases} cases "
          f"(incl. cm[1,1] = {int(got['cm'][1, 1])} > 2^24); max count difference {worst}")
    return worst


def phase_slice(torch, em, device):
    """Phase 4: the port's evaluate() on the full-width selective UNet_B.

    A global forward hook records the input and the two heads of every
    forward the model makes inside evaluate(). evaluate()'s own totals must
    then equal the plain version applied to those very logits, with labels
    taken straight from the dataset (not from the loader), and the inputs it
    saw must equal the dataset's patches, normalised, in order, with the
    padding of the last batch at zero pixels."""
    from selectivenet_for_semantic_segmentation_binary_torch.config import EvalConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import (
        device_preprocess, evaluate, load_models, make_eval_step)
    from selectivenet_for_semantic_segmentation_binary_torch.models import UNetB
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches, seeded_model)

    # the float32 forward on the card against the CPU's, on a small input
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = seeded_model(SEED, "float32")
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(SEED))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        cpu_out = small(x)
        gpu_out = small.to(device)(x.to(device))
    fwd_err = max(float((c - gg.cpu()).abs().max()) for c, gg in zip(cpu_out, gpu_out))
    fwd_scale = max(float(c.abs().max()) for c in cpu_out)
    print(f"[phase 4] float32 forward, card vs CPU at 2x3x64x64: max |diff| {fwd_err:.3e} "
          f"(max |logit| {fwd_scale:.3e}; tolerance 1e-3 x max |logit|)")
    if not fwd_err <= 1e-3 * fwd_scale:
        raise AssertionError("the forward on the card disagrees with the CPU")
    torch.backends.cudnn.allow_tf32 = True
    del small

    data = InMemoryPatches(N_PATCHES, SIZE, SEED)
    loader = PatchLoader(data, BATCH, num_workers=8, device=device)
    seen = []

    def record(module, args, out):
        if isinstance(module, UNetB):
            seen.append((args[0], out[0], out[1]))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_") as model_dir:
        torch.save({"net": seeded_model(SEED, "bfloat16").state_dict()},
                   os.path.join(model_dir, "model_epoch1.pth"))
        cfg = EvalConfig(model_dir=model_dir, model_arch=["UNet_B"], selective=True,
                         select_eval=True, batch_size=BATCH, patch_size=SIZE,
                         compute_dtype="bfloat16", use_pallas=True, num_workers=8)
        hook = torch.nn.modules.module.register_module_forward_hook(record)
        em.launches = 0
        t0 = time.perf_counter()
        try:
            results = evaluate(cfg, loader=loader, verbose=True, device=device)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        wall = time.perf_counter() - t0
        launches = em.launches
        models = load_models(cfg, device)
    print(f"[phase 4] evaluate(): {N_PATCHES} patches of {SIZE}x{SIZE} at batch {BATCH}, "
          f"bfloat16, {wall:.3f} s wall (incl. checkpoint load and first-call set-up); "
          f"eval_metrics kernel launches: {launches}")
    if launches != len(loader):
        raise AssertionError(f"the main path launched the eval_metrics kernel {launches} "
                             f"times for {len(loader)} batches")
    for key in ("accuracy", "accuracy_class", "mIoU", "rejection_ratio"):
        if not np.isfinite(results[key]):
            raise AssertionError(f"{key} is not finite: {results[key]}")
    if not 0.0 <= results["rejection_ratio"] <= 1.0:
        raise AssertionError(f"rejection_ratio {results['rejection_ratio']} outside [0, 1]")
    if len(seen) != len(loader):
        raise AssertionError(f"evaluate() ran {len(seen)} forwards for {len(loader)} batches")

    kw = dict(apply_sigmoid=True, selective=True, cut_off=cfg.cut_off,
              s_cut_off=cfg.s_cut_off)
    cm = torch.zeros((2, 2), dtype=torch.int64, device=device)
    n_pix = n_reject = 0
    for b, (x, out, sel) in enumerate(seen):
        lo = b * BATCH
        n = min(BATCH, N_PATCHES - lo)
        want_x, _ = device_preprocess(
            {"input": torch.from_numpy(data.inputs[lo:lo + n]).to(device), "label": None})
        if not (torch.equal(x[:n], want_x) and bool((x[n:] == -1.0).all())):
            raise AssertionError(f"batch {b}: the inputs evaluate() saw are not the "
                                 f"dataset's patches {lo}..{lo + n - 1} plus zero padding")
        label = torch.from_numpy(data.labels[lo:lo + n]).to(device)
        want = em.eval_metrics_reference(out[:n], label, sel[:n], **kw)
        got = em.fused_eval_metrics(out[:n], label, sel[:n], **kw)
        if not same_counts(got, want):
            raise AssertionError(f"batch {b}: kernel {got} != plain version {want} "
                                 f"on evaluate()'s logits")
        cm += want["cm"]
        n_pix += int(want["n_pix"])
        n_reject += int(want["n_reject"])
    cm = cm.cpu().numpy()
    if not np.array_equal(cm, results["confusion_matrix"].astype(np.int64)):
        raise AssertionError(f"evaluate()'s confusion matrix {results['confusion_matrix']} "
                             f"!= the plain version's on its logits {cm}")
    if n_pix != N_PATCHES * SIZE * SIZE:
        raise AssertionError(f"n_pix {n_pix} != {N_PATCHES}*{SIZE}^2")
    if results["rejection_ratio"] != n_reject / n_pix:
        raise AssertionError(f"evaluate()'s rejection_ratio {results['rejection_ratio']!r} "
                             f"!= {n_reject}/{n_pix} from the plain version")
    print(f"[phase 4] evaluate()'s confusion matrix and rejection ratio == the plain "
          f"version on evaluate()'s own logits and the dataset's labels, batch by batch "
          f"({len(seen)} batches; the kernel equal too); inputs == the dataset's patches; "
          f"n_pix = {n_pix} = {N_PATCHES}*{SIZE}^2; n_reject = {n_reject}; "
          f"rejection_ratio {results['rejection_ratio']:.6f}; mIoU {results['mIoU']:.6f}")
    step = make_eval_step(models, cfg, use_kernel=True)
    return models, step, next(iter(loader)), launches


def phase_timings(torch, em, models, step, batch, card: str, against=None) -> dict:
    """Phase 5, at batch 128, 256x256, bfloat16; with ``against`` (another
    commit's kernels/), the kernel against its build there, in turns."""
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import device_preprocess
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        bound_ms, median_ms_device)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)

    model = models[0]
    with torch.inference_mode():
        step_ms = median_ms(lambda: step(batch), RUNS, WARMUP)
        x, label = device_preprocess(batch)
        fwd_ms = median_ms(lambda: model(x), RUNS, WARMUP)
        out, sel, _aux = model(x)
    kw = dict(apply_sigmoid=True, selective=True, cut_off=0.5, s_cut_off=0.5)
    # plain, kernel, kernel, plain: both sides see the same clocks
    plain_a = median_ms_device(lambda: em.eval_metrics_reference(out, label, sel, **kw))
    kern_a = median_ms_device(lambda: em.fused_eval_metrics(out, label, sel, **kw))
    kern_b = median_ms_device(lambda: em.fused_eval_metrics(out, label, sel, **kw))
    plain_b = median_ms_device(lambda: em.eval_metrics_reference(out, label, sel, **kw))
    kern_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    nbytes = out.numel() * (out.element_size() + sel.element_size() + label.element_size())
    print(f"[phase 5] on {card}: eval step (preprocess + forward + metrics), batch {BATCH}, "
          f"{SIZE}x{SIZE}, bfloat16: {step_ms:.3f} ms median -> "
          f"{BATCH / step_ms * 1e3:.2f} patches/s")
    print(f"[phase 5] on {card}: forward alone: {fwd_ms:.3f} ms median -> "
          f"{BATCH / fwd_ms * 1e3:.2f} patches/s")
    print(f"[phase 5] on {card}: eval_metrics device time at {tuple(out.shape)} (selective, sigmoid, "
          f"uint8 labels, {nbytes} bytes read; one launch, {em.kernel_path(out, label, sel)} "
          f"path): "
          f"kernel {kern_ms * 1e3:.2f} us "
          f"({nbytes / kern_ms / 1e6:.1f} GB/s; medians {kern_a * 1e3:.2f}/{kern_b * 1e3:.2f} us), "
          f"plain version {plain_ms * 1e3:.2f} us ({nbytes / plain_ms / 1e6:.1f} GB/s; "
          f"medians {plain_a * 1e3:.2f}/{plain_b * 1e3:.2f} us)")
    bound = bound_ms(nbytes + 6 * 8, 0)
    print(f"[phase 5] on {card}: eval_metrics bound {bound['bound_ms'] * 1e3:.2f} us "
          f"({bound['bound_by']}); kernel at {bound['bound_ms'] / kern_ms:.1%} of it")
    if against:
        from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
            eval_metrics_against)

        r = eval_metrics_against.compare(eval_metrics_against.other_k1(against), out, label, sel)
        print(f"[phase 5] on {card}: eval_metrics in turns with the other build ({against}): "
              f"other {r['other_ms'] * 1e3:.2f} us, this {r['ms'] * 1e3:.2f} us "
              f"({r['other_ms'] / r['ms']:.2f}x); bound {r['bound_ms'] * 1e3:.2f} us")
    return {"ms": kern_ms, "plain_ms": plain_ms, "library_ms": None, **bound}


def cbr_inputs(torch, g, device, n, h, w, cin, cout):
    """Seeded bf16 inputs of the fused-CBR kernel at one layer's shape; the
    prologue shift b is nonzero, so relu(b) would show in a leaking halo."""
    x = (torch.randn((n, h, w, cin), generator=g, device=device) * 2.0 + 0.3).to(torch.bfloat16)
    a = torch.rand((cin,), generator=g, device=device) + 0.5
    b = torch.randn((cin,), generator=g, device=device) * 0.5
    wt = torch.randn((3, 3, cin, cout), generator=g, device=device) * math.sqrt(2.0 / (9 * cin))
    bias = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, a, b, wt.to(torch.bfloat16), bias


def cbr_exact(torch, x, a, b, w, bias, prologue):
    """y rounded ONCE from a float32 conv (TF32 off) of the same bf16
    operands: the kernel's arithmetic up to the order of its sums."""
    import torch.nn.functional as F

    xn = torch.relu(x.float() * a + b).to(x.dtype) if prologue else x
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xn.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return (y.permute(0, 2, 3, 1) + bias).to(x.dtype)


def cbr_sums(torch, y):
    """([sum y, sum y^2], [sum |y|, sum y^2]) per channel, in float32."""
    yf = y.float()
    sq = (yf * yf).sum((0, 1, 2))
    return torch.stack([yf.sum((0, 1, 2)), sq]), torch.stack([yf.abs().sum((0, 1, 2)), sq])


def check_cbr_case(torch, phase: int, name: str, kernel, args, prologue: bool) -> float:
    """One case of phases 6 and 9: ``kernel()`` (called twice) against the
    exact reference and the plain version. Returns max |y_kernel - y_plain|.

    Tolerances, bf16 y: against the exact reference (rounded once, like the
    kernel) 2^-7 |y| + 2^-16 max|y|, i.e. one or two bf16 ulps, since the
    float32 sums run in another order; against the plain version
    2^-6 (|y| + |bias|) + 2^-16 max|y|, since it rounds the conv output to
    bf16 before adding the bias. Stats, relative to [sum |y|, sum y^2]:
    1e-5 against the sums of the kernel's own y (float32 order only), 1e-3
    against the exact reference's, 1e-2 against the plain version's (cuDNN's
    bf16 conv output carries a systematic bias of a few 1e-3 in sum y^2)."""
    from selectivenet_for_semantic_segmentation_binary_torch.ops.fused_cbr import (
        fused_conv_stats_reference)

    x, a, b, wt, bias = args
    y, s = kernel()
    y2, s2 = kernel()
    yp, sp = fused_conv_stats_reference(x, a, b, wt, bias, prologue)
    ye = cbr_exact(torch, x, a, b, wt, bias, prologue)
    torch.cuda.synchronize()
    yk, ypf, yef = y.float(), yp.float(), ye.float()
    floor = 2.0 ** -16 * float(yef.abs().max())
    own, scale = cbr_sums(torch, y)
    exact_s, _ = cbr_sums(torch, ye)

    def rel(t):
        return float(((s - t).abs() / scale.clamp_min(1e-30)).max())

    bad = []
    if not bool(((yk - yef).abs() <= 2.0 ** -7 * yef.abs() + floor).all()):
        bad.append("y vs the exact reference")
    if not bool(((yk - ypf).abs() <= 2.0 ** -6 * (ypf.abs() + bias.abs()) + floor).all()):
        bad.append("y vs the plain version")
    errs = (rel(own), rel(exact_s), rel(sp))
    for what, e, tol in zip(("own y", "exact", "plain"), errs, (1e-5, 1e-3, 1e-2)):
        if not e <= tol:
            bad.append(f"stats vs {what}: {e:.3e} > {tol}")
    if not (torch.equal(y, y2) and torch.equal(s, s2)):
        bad.append("two runs differ")
    err = float((yk - ypf).abs().max())
    n, h, w, cin = x.shape
    print(f"[phase {phase}] {name} {n}x{h}x{w} {cin}->{wt.shape[-1]} prologue={prologue}: "
          f"max|y - plain| {err:.3e}, max|y - exact| {float((yk - yef).abs().max()):.3e} "
          f"(max|y| {float(yef.abs().max()):.3e}); stats rel. to own/exact/plain "
          f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}; run to run identical")
    if bad:
        raise AssertionError(f"{name} at {(n, h, w, cin, wt.shape[-1])} "
                             f"prologue={prologue}: {bad}")
    return err


def phase_cbr_kernel(torch, fc, device) -> float:
    """Phase 6. Returns the largest |y_kernel - y_plain| seen (tolerances in
    ``check_cbr_case``). Gradients through the autograd.Function against
    autograd of the plain version: 2e-2 of the largest |gradient| (bf16
    operands and cotangents)."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import CBR_LAYERS

    g = torch.Generator(device=device).manual_seed(SEED)
    shapes = sorted({(cin, cout, size) for _, cin, cout, size, _ in CBR_LAYERS})
    # a tile holds 8 samples: batch 2 checks only tiles at sample 0; the main
    # path's batch 128, N = 16 and a ragged N = 19 (a tile of 3) at both tile
    # widths (Cout 64, Cout a multiple of 128) check the tiles past it
    cases = ([(n, size, size, cin, cout) for n in (2, BATCH) for cin, cout, size in shapes]
             + [(3, 33, 47, 64, 128), (16, 16, 16, 64, 64), (19, 9, 13, 64, 64),
                (16, 16, 16, 128, 256), (19, 9, 13, 256, 128)])
    worst = 0.0
    for n, h, w, cin, cout in cases:
        for prologue in (True, False):
            args = cbr_inputs(torch, g, device, n, h, w, cin, cout)
            worst = max(worst, check_cbr_case(
                torch, 6, "fused_conv_stats",
                lambda: fc.fused_conv_stats(*args, prologue), args, prologue))
            del args

    # a = 0, b > 0 in every other channel: relu(b) inside the image, zero in
    # the halo
    for n, h, w, cin, cout in ((3, 9, 13, 64, 128), (2, 16, 16, 128, 64)):
        args = cbr_inputs(torch, g, device, n, h, w, cin, cout)
        args[1][::2] = 0.0
        args[2][::2] = 0.7
        worst = max(worst, check_cbr_case(
            torch, 6, "fused_conv_stats (a=0, b=0.7)",
            lambda: fc.fused_conv_stats(*args, True), args, True))

    x, a, b, wt, bias = cbr_inputs(torch, g, device, 2, 32, 32, 64, 128)
    grads = []
    for fn in (fc.fused_conv_stats, fc.fused_conv_stats_reference):
        args = [t.detach().clone().requires_grad_(True) for t in (x, a, b, wt, bias)]
        y, s = fn(*args, True)
        mean, var = fc.moments_from_stats(s, y.shape[0] * y.shape[1] * y.shape[2])
        ((y.float() ** 2).sum() * 1e-3 + mean.sum() + var.sum()).backward()
        grads.append([t.grad.float() for t in args])
    for name, gk, gp in zip(("x", "a", "b", "w", "bias"), *grads):
        e = float((gk - gp).abs().max()) / float(gp.abs().max())
        print(f"[phase 6] gradient of {name}: max|kernel - plain| / max|plain| {e:.3e}")
        if not e <= 2e-2:
            raise AssertionError(f"gradient of {name} through the kernel disagrees: {e:.3e}")
    print(f"[phase 6] fused_conv_stats == plain version within the stated tolerances in "
          f"{2 * len(cases) + 2} cases ({len(shapes)} layer shapes at batch 2 and {BATCH}, "
          f"3x33x47 and four at N = 16 and 19, prologue on and off; two at a=0, b>0 in half "
          f"the channels), run-to-run identical; max |y - plain| {worst:.3e}")
    return worst


def phase_train(torch, fc, device):
    """Phase 7: the port's train() on the full-width selective UNet_B."""
    import dataclasses

    from selectivenet_for_semantic_segmentation_binary_torch.config import (
        EvalConfig, TrainConfig)
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import evaluate
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        make_train_step, train)

    train_set = InMemoryPatches(N_TRAIN, SIZE, SEED + 1)
    valid_set = InMemoryPatches(N_VALID, SIZE, SEED + 2)

    def loaders():
        return (PatchLoader(train_set, BATCH, num_workers=8, device=device, shuffle=True,
                            drop_last=True, seed=SEED, random_flip=True),
                PatchLoader(valid_set, BATCH, num_workers=8, device=device, seed=SEED))

    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import CBR_LAYERS

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as model_dir:
        cfg = TrainConfig(model_dir=model_dir, fold=1, model_arch="UNet_B", selective=True,
                          loss="BCElogit", batch_size=BATCH, patch_size=SIZE, n_epoch=1,
                          compute_dtype="bfloat16", fused_cbr="on", num_workers=8, seed=SEED)
        lt, lv = loaders()
        fc.launches = 0
        t0 = time.perf_counter()
        result = train(cfg, loaders=(lt, lv), verbose=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fc.launches
        want = len(CBR_LAYERS) * (len(lt) + len(lv))
        print(f"[phase 7] train(): 1 epoch, {len(lt)} train batches + {len(lv)} valid batches "
              f"of {BATCH} at {SIZE}x{SIZE}, bfloat16, --fused_cbr on: {wall:.3f} s wall "
              f"(incl. first-call set-up); fused_conv_stats launches {launches} "
              f"(want {len(CBR_LAYERS)} x {len(lt) + len(lv)} = {want})")
        if launches != want:
            raise AssertionError(f"the train path launched fused_conv_stats {launches} times, "
                                 f"want {want}")
        tr, va = result["train"], result["valid"]
        values = {"train loss": tr.loss, "train aux loss": tr.aux_loss,
                  "train selection loss": tr.sel_loss, "valid loss": va.loss,
                  "valid aux loss": va.aux_loss, "valid selection loss": va.sel_loss}
        for name, v in values.items():
            if not math.isfinite(v):
                raise AssertionError(f"{name} is not finite: {v}")
        if not (tr.sel_loss >= 0 and va.sel_loss >= 0):
            raise AssertionError(f"negative selection loss: {tr.sel_loss}, {va.sel_loss}")
        first = os.path.join(cfg.ckpt_dir, "model_epoch1.pth")
        if not os.path.exists(first):
            raise AssertionError(f"{first} was not written")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            again = train(dataclasses.replace(cfg, keep_ckpt=1), loaders=loaders(),
                          device=device)
        print(out.getvalue(), end="")
        files = sorted(os.listdir(cfg.ckpt_dir))
        if (again["epoch"] != 2 or f"Load weights from {first}" not in out.getvalue()
                or files != ["model_epoch2.pth"]):
            raise AssertionError(f"resume failed: epoch {again['epoch']}, files {files}")
        print(f"[phase 7] a second train() resumed from {os.path.basename(first)} at epoch 2; "
              f"--keep_ckpt 1 left {files}")

        ecfg = EvalConfig(model_dir=cfg.ckpt_dir, model_arch=["UNet_B"], selective=True,
                          select_eval=True, batch_size=BATCH, patch_size=SIZE,
                          compute_dtype="bfloat16", num_workers=8)
        res = evaluate(ecfg, loader=PatchLoader(valid_set, BATCH, num_workers=8, device=device),
                       verbose=False, device=device)
        if not (math.isfinite(res["accuracy"]) and 0.0 <= res["rejection_ratio"] <= 1.0):
            raise AssertionError(f"evaluate() of the trained file: {res}")
        print(f"[phase 7] evaluate() scored model_epoch2.pth on the {N_VALID} validation "
              f"patches: accuracy {res['accuracy']:.6f}, rejection ratio "
              f"{res['rejection_ratio']:.6f}, mIoU {res['mIoU']:.6f}")
        state = {k: v.detach().clone() for k, v in again["model"].state_dict().items()}
        del result, again

    # one train step each, fused and classic trunk, same weights and batch
    batch = next(iter(loaders()[0]))
    steps, losses = {}, {}
    for fused in (True, False):
        model = build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=fused)
        load_weights(model, state)
        model.to(device)
        step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
        metrics = step(batch, cfg.lr)
        losses[fused] = (float(metrics["loss"]), float(metrics["coverage"]))
        steps[fused] = (model, step)
    # the steps wait for the host nowhere, the confusion counts included:
    # CUDA raises at any synchronising call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fused in (True, False):
            steps[fused][1](batch, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[phase 7] one more train step each, fused and classic trunk, under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")
    (lf, cf), (lc, cc) = losses[True], losses[False]
    rel = abs(lf - lc) / abs(lc)
    print(f"[phase 7] one train step from the same weights and batch: loss fused {lf:.6f} vs "
          f"classic {lc:.6f} (rel. diff {rel:.3e}, tolerance 1e-2: the trunks round to bf16 "
          f"at different places); coverage {cf:.6f} vs {cc:.6f}")
    if not rel <= 1e-2:
        raise AssertionError("the fused and the classic trunk disagree on the loss")
    return launches, steps, batch


def phase_train_timings(torch, fc, device, steps, batch, card: str) -> dict:
    """Phase 8, at batch 128, 256x256, bfloat16."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        CBR_LAYERS, bound_ms, cbr_bytes, median_ms_device, summed_bounds)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        device_preprocess)

    names = {True: "fused trunk", False: "classic trunk"}
    order = (False, True, True, False)  # both sides see the same clocks
    step_ms, fwd_ms = {True: [], False: []}, {True: [], False: []}
    for fused in order:
        step_ms[fused].append(median_ms(lambda: steps[fused][1](batch, 1e-3), TRAIN_RUNS, 2))
    peak = {}
    for fused in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps[fused][1](batch, 1e-3)
        torch.cuda.synchronize()
        peak[fused] = torch.cuda.max_memory_allocated() / 2 ** 30
    x, _ = device_preprocess(batch)
    with torch.no_grad():
        for fused in order:
            model = steps[fused][0].eval()
            fwd_ms[fused].append(median_ms(lambda: model(x), RUNS, WARMUP))
    for fused in (True, False):
        s, f = statistics.mean(step_ms[fused]), statistics.mean(fwd_ms[fused])
        print(f"[phase 8] on {card}: train step, {names[fused]}, batch {BATCH}, {SIZE}x{SIZE}, "
              f"bfloat16: {s:.3f} ms ({BATCH / s * 1e3:.2f} patches/s; medians "
              f"{'/'.join(f'{v:.3f}' for v in step_ms[fused])}); peak memory {peak[fused]:.2f} GiB; "
              f"eval-mode forward {f:.3f} ms ({BATCH / f * 1e3:.2f} patches/s; medians "
              f"{'/'.join(f'{v:.3f}' for v in fwd_ms[fused])})")

    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(SEED)
    total_k = total_p = total_c = 0.0
    bounds = []
    with torch.no_grad():
        for name, cin, cout, size, prologue in CBR_LAYERS:
            args = cbr_inputs(torch, g, device, BATCH, size, size, cin, cout)
            p1 = median_ms_device(lambda: fc.fused_conv_stats_reference(*args, prologue))
            k1 = median_ms_device(lambda: fc.fused_conv_stats(*args, prologue))
            k2 = median_ms_device(lambda: fc.fused_conv_stats(*args, prologue))
            p2 = median_ms_device(lambda: fc.fused_conv_stats_reference(*args, prologue))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            # the cuDNN conv alone at this shape (conv + bias, no prologue, no
            # stats): a yardstick, not the same function
            xc = args[0].permute(0, 3, 1, 2)
            wc = args[3].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = args[4].to(torch.bfloat16)
            c = median_ms_device(lambda: F.conv2d(xc, wc, bc, padding=1))
            flop = 2 * BATCH * size * size * 9 * cin * cout
            bounds.append(bound_ms(cbr_bytes(BATCH, size, size, cin, cout), flop))
            print(f"[phase 8] on {card}: {name} {cin}->{cout} at {size}x{size}, prologue "
                  f"{'on' if prologue else 'off'}: kernel {k:.3f} ms ({flop / k / 1e9:.1f} "
                  f"TFLOP/s; {k1:.3f}/{k2:.3f}), plain version {p:.3f} ms "
                  f"({flop / p / 1e9:.1f} TFLOP/s; {p1:.3f}/{p2:.3f}), cuDNN conv alone "
                  f"{c:.3f} ms, bound {bounds[-1]['bound_ms']:.3f} ms")
            total_k += k
            total_p += p
            total_c += c
            del args, xc, wc
    print(f"[phase 8] on {card}: the 13 kernel layers of one forward at batch {BATCH}: "
          f"kernel {total_k:.3f} ms, plain version {total_p:.3f} ms, cuDNN conv alone "
          f"{total_c:.3f} ms (device time)")
    return {"ms": total_k, "plain_ms": total_p, "library_ms": None, **summed_bounds(bounds)}


def phase_rows_kernel(torch, fr, device) -> float:
    """Phase 9: fused_cbr_rows as phase 6 holds fused_conv_stats, at the
    (H, W, Cin, Cout, rows) of its script's 12 shapes (batch 2) and two
    ragged shapes (both tile widths; Cin = 32, a last chunk of 32 channels).
    Returns max |y - plain|."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_fused_cbr import (
        SHAPES)

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    cases = sorted({(2, h, w, cin, cout, rows) for _, h, w, cin, cout, rows in SHAPES.values()})
    cases += [(3, 33, 47, 64, 128, 1), (2, 5, 70, 32, 64, 5)]
    worst = 0.0
    for n, h, w, cin, cout, rows in cases:
        for prologue in (True, False):
            args = cbr_inputs(torch, g, device, n, h, w, cin, cout)
            worst = max(worst, check_cbr_case(
                torch, 9, f"fused_cbr_rows rows={rows}",
                lambda: fr.fused_cbr(*args, rows=rows, apply_prologue=prologue), args, prologue))
    print(f"[phase 9] fused_cbr_rows == plain version within phase 6's tolerances in "
          f"{2 * len(cases)} cases, run-to-run identical; max |y - plain| {worst:.3e}")
    return worst


def phase_dw_kernel(torch, cd, device) -> float:
    """Phase 10: conv_dw against float64 of the same operands (rounded once)
    and the plain version, DW_EXACT_TOL and DW_PLAIN_TOL of max |dW|.
    Returns max |dW - plain|."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.proto_pallas_dw import (
        CHECK_SHAPES, SHAPES)

    g = torch.Generator(device=device).manual_seed(SEED + 10)
    cases = [(h, h, 8, ci, co, th, tw, "bfloat16") for h, ci, co, th, tw, _ in SHAPES.values()]
    for shape in CHECK_SHAPES + [(9, 13, 3, 64, 128, 1, 1)]:
        cases += [shape + ("bfloat16",), shape + ("float32",)]
    worst = 0.0
    for i, (h, w, n, ci, co, th, tw, dtype) in enumerate(cases):
        x = torch.randn((h, w, n, ci), generator=g, device=device).to(getattr(torch, dtype))
        gy = torch.randn((h, w, n, co), generator=g, device=device).to(getattr(torch, dtype))
        variant = ("taps9", "x3g3")[i % 2]
        got = cd.conv3x3_dw(x, gy, TH=th, TW=tw, variant=variant)
        again = cd.conv3x3_dw(x, gy, TH=th, TW=tw, variant=("taps9", "x3g3")[1 - i % 2])
        exact = cd.conv3x3_dw_reference(x.double(), gy.double())
        plain = cd.conv3x3_dw_reference(x, gy)
        scale = float(exact.abs().max())
        e_exact = float((got - exact).abs().max()) / scale
        e_plain = float((got - plain).abs().max()) / float(plain.abs().max())
        err = float((got - plain).abs().max())
        worst = max(worst, err)
        print(f"[phase 10] conv_dw {dtype} {h}x{w} N{n} {ci}->{co} T({th},{tw}) {variant}: "
              f"rel. to max|dW| {e_exact:.2e} from float64, {e_plain:.2e} from the plain "
              f"version (max abs {err:.3e}); both variants identical")
        if not (e_exact <= DW_EXACT_TOL[dtype] and e_plain <= DW_PLAIN_TOL[dtype]
                and torch.equal(got, again)):
            raise AssertionError(f"conv_dw at {(h, w, n, ci, co, dtype)}: {e_exact:.3e} from "
                                 f"float64, {e_plain:.3e} from the plain version, identical "
                                 f"{torch.equal(got, again)}")
    print(f"[phase 10] conv_dw within the stated tolerances in {len(cases)} cases; max |dW - "
          f"plain| {worst:.3e}")
    return worst


def phase_bn_kernel(torch, bs, device) -> float:
    """Phase 11: bn_stats against float64 sums and the plain version: within
    1e-5 of sum |x| (sum) and of sum x^2 (sumsq). Returns the largest
    |kernel - plain| over both sums."""
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    worst = 0.0
    # the script's shape; 2050 rows (the TPU grid would drop a tail); an odd count
    for shape in ((128, 256, 256, 64), (1, 50, 41, 64), (3, 33, 47, 64)):
        x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(torch.bfloat16)
        s, q = bs.bn_stats(x)
        s2, q2 = bs.bn_stats(x)
        ps, pq = bs.bn_stats_reference(x)
        xd = x.double().reshape(-1, 64)
        es, eq = xd.sum(0), (xd * xd).sum(0)
        scale_s, scale_q = float(xd.abs().sum()), float(eq.sum())
        del xd
        rel = [float((s.double() - es).abs().max()) / scale_s,
               float((q.double() - eq).abs().max()) / scale_q,
               float((s - ps).abs().max()) / scale_s, float((q - pq).abs().max()) / scale_q]
        worst = max(worst, float((s - ps).abs().max()), float((q - pq).abs().max()))
        print(f"[phase 11] bn_stats {shape}: sum/sumsq rel. to sum|x|/sum x^2 "
              f"{rel[0]:.2e}/{rel[1]:.2e} from float64, {rel[2]:.2e}/{rel[3]:.2e} from the "
              f"plain version; run to run identical")
        if not (max(rel) <= 1e-5 and torch.equal(s, s2) and torch.equal(q, q2)):
            raise AssertionError(f"bn_stats at {shape}: {rel}, identical "
                                 f"{torch.equal(s, s2) and torch.equal(q, q2)}")
        del x
    return worst


def phase_proto_benches(torch, fr, cd, bs, card: str, against=None) -> dict:
    """Phase 12: the three entry points at their scripts' batch-128 shapes,
    with the launch counters set to 0 just before and read just after; with
    ``against`` (another commit's kernels/), K3 against its build there."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
        proto_bn_stats, proto_fused_cbr, proto_pallas_dw)
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        bound_ms, cbr_bytes, summed_bounds)

    print(f"[phase 12] on {card}: proto_fused_cbr.bench()")
    fr.launches = cd.launches = bs.launches = 0
    cbr = proto_fused_cbr.bench()
    print(f"[phase 12] on {card}: proto_pallas_dw.check() and .bench()")
    proto_pallas_dw.check()
    dw = proto_pallas_dw.bench()
    print(f"[phase 12] on {card}: proto_bn_stats.bench()")
    bn = proto_bn_stats.bench()
    launches = {"fused_cbr_rows": fr.launches, "conv_dw": cd.launches, "bn_stats": bs.launches}
    print(f"[phase 12] kernel launches through the entry points: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the entry points never launched {name}")
    # bytes: K3 as any fused CBR; K5 reads x and dy in bf16 and writes dW in
    # float32; K4 reads x and writes two float32 sums per channel
    out = {
        "fused_cbr_rows": {"ms": sum(r["ms"] for r in cbr),
                           "plain_ms": sum(r["plain_ms"] for r in cbr), "library_ms": None,
                           **summed_bounds([bound_ms(cbr_bytes(*r["shape"]), r["flops"])
                                            for r in cbr])},
        "conv_dw": {"ms": sum(r["ms"] for r in dw), "plain_ms": sum(r["plain_ms"] for r in dw),
                    "library_ms": sum(r["nhwc_ms"] for r in dw),
                    **summed_bounds([bound_ms(
                        2 * r["h"] * r["h"] * proto_pallas_dw.N * (r["ci"] + r["co"])
                        + 4 * 9 * r["ci"] * r["co"], r["flops"]) for r in dw])},
        "bn_stats": {"ms": bn["ms"], "plain_ms": bn["plain_ms"], "library_ms": bn["library_ms"],
                     **bound_ms(bn["bytes"] + 2 * 4 * bn["shape"][-1], 0)},
    }
    print(f"[phase 12] on {card}: summed over the shapes, device ms: fused_cbr_rows "
          f"{out['fused_cbr_rows']['ms']:.3f} vs plain chain "
          f"{out['fused_cbr_rows']['plain_ms']:.3f} vs the cuDNN conv alone "
          f"{sum(r['conv_ms'] for r in cbr):.3f}; conv_dw "
          f"{out['conv_dw']['ms']:.3f} vs cuDNN as given {out['conv_dw']['plain_ms']:.3f} vs "
          f"cuDNN NHWC {sum(r['nhwc_ms'] for r in dw):.3f}; bn_stats {bn['ms']:.4f} vs plain "
          f"{bn['plain_ms']:.4f} vs torch.var_mean {bn['library_ms']:.4f}")
    for name in out:
        out[name]["launches"] = launches[name]
    if against:
        print(f"[phase 12] on {card}: proto_fused_cbr.bench(other_dir={against!r}), K3 of the "
              f"other build and of this one in turns")
        pair = proto_fused_cbr.bench(other_dir=against)
        other_ms, this_ms = (sum(r[k] for r in pair) for k in ("other_ms", "this_ms"))
        print(f"[phase 12] on {card}: K3 over its {len(pair)} shapes, in turns: other build "
              f"{other_ms:.3f} ms, this one {this_ms:.3f} ms ({other_ms / this_ms:.2f}x)")
    return out


# phase 13's shapes (N, H, W, Cin, Cout): the script's check shape, every
# channel width of UNet_B and one Cin != Cout at N=128; one 64-sample block,
# a partial one (104) and a third (136), and N = 100 and 130 (N % 8 != 0:
# the element path, as N = 3); Cin = 32 and 96 (a last chunk of 32
# channels); W = 11 (a ragged column tile) and H = 1
TC_CASES = ((8, 32, 32, 64, 64), (128, 32, 32, 64, 64), (128, 32, 32, 128, 128),
            (128, 32, 32, 256, 256), (128, 32, 32, 512, 512), (128, 32, 32, 512, 256),
            (64, 16, 16, 64, 64), (104, 16, 16, 64, 64), (136, 8, 8, 64, 128),
            (100, 16, 16, 64, 64), (130, 8, 8, 64, 128),
            (16, 16, 16, 32, 64), (16, 16, 16, 96, 128), (16, 9, 11, 64, 64),
            (16, 1, 16, 64, 64), (3, 32, 32, 64, 64))


def phase_transposed_cbr(torch, tc, device) -> dict:
    """Phase 13: transposed_cbr v1 and v2 as phase 6 holds fused_conv_stats
    (``check_cbr_case``, on the NHWC views), v1 == v2 bit for bit. Returns
    the largest |y - plain| of each."""
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    versions = {"v1": tc.transposed_fused_cbr, "v2": tc.transposed_fused_cbr_v2}
    worst = {"v1": 0.0, "v2": 0.0}

    def check_both(args, prologue, what):
        xt = tc.from_nhwc(args[0]).contiguous()
        ys = {}
        for version, fn in versions.items():
            def kernel():
                y, s = fn(xt, *args[1:], rows=1, w_blk=1, apply_prologue=prologue)
                ys[version] = y
                return tc.to_nhwc(y), s
            worst[version] = max(worst[version], check_cbr_case(
                torch, 13, f"transposed_cbr {version}{what}", kernel, args, prologue))
        if not torch.equal(ys["v1"], ys["v2"]):
            raise AssertionError(f"transposed_cbr v1 != v2{what} at {tuple(args[0].shape)}")

    for n, h, w, cin, cout in TC_CASES:
        for prologue in (True, False):
            args = cbr_inputs(torch, g, device, n, h, w, cin, cout)
            check_both(args, prologue, f" [{tc.kernel_path(tc.from_nhwc(args[0]))} path]")
    # a channel at a = 0, b > 0: the JAX v2's pad ring maps to relu(b) there
    args = cbr_inputs(torch, g, device, 128, 32, 32, 64, 64)
    args[1][7], args[2][7] = 0.0, 0.7
    check_both(args, True, " (a=0, b=0.7 in channel 7)")
    print(f"[phase 13] transposed_cbr v1 and v2 == plain version within phase 6's tolerances "
          f"in {2 * (2 * len(TC_CASES) + 1)} cases, run-to-run identical, v1 == v2 bit for bit "
          f"(also at a=0, b>0); max |y - plain| v1 {worst['v1']:.3e}, v2 {worst['v2']:.3e}")
    return worst


def phase_bisect(torch, device) -> dict:
    """Phase 14: every K7/K8/K9 variant through its script's comparison
    (``bisect_transposed.hold``: K7's and K8's copies and sums equal to the
    plain version, dots within one bf16 ulp), on ones and on a seeded
    input, at each of ``BISECT_SHAPES``; each case's line names the path its
    K7/K8 kernel took (16-byte vectors or elements). Phase 15's timed
    ``main`` holds them at the scripts' own size. Returns the largest
    |kernel - plain| of each kernel."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
        bisect_transposed, bisect_transposed2, bisect_transposed3)

    worst = {}
    for kernel, script in (("K7", bisect_transposed), ("K8", bisect_transposed2),
                           ("K9", bisect_transposed3)):
        for n, h, w, c in BISECT_SHAPES:
            print(f"[phase 14] {script.__name__.rsplit('.', 1)[-1]}.run(n={n}, h={h}, w={w}, "
                  f"c={c})")
            results = script.run(device=device, n=n, h=h, w=w, c=c)
            err = max(r["max_abs_err"] for r in results)
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            paths = sorted({r["path"] for r in results if r["path"]})
            print(f"[phase 14] {kernel} at (N, H, W, C) = ({n}, {h}, {w}, {c}) == plain version "
                  f"in {len(results)} cases{', paths ' + ', '.join(paths) if paths else ''}; "
                  f"max |y - plain| {err:.3e}")
    return worst


def one_call_summary(results) -> dict:
    """Over a script's timed cases, those that one PyTorch call also computes:
    their count, the kernel's device ms summed over them and the one call's
    (``library_ms``, None where no case has one call)."""
    cases = [r for r in results if r["library_ms"] is not None]
    return {"one_call_cases": len(cases), "ms_on_one_call_cases": sum(r["ms"] for r in cases),
            "library_ms": sum(r["library_ms"] for r in cases) if cases else None}


def _one_call_sum(results) -> str:
    """The one PyTorch call's device ms summed over the cases that have one."""
    s = one_call_summary(results)
    if not s["one_call_cases"]:
        return "none"
    return (f"{s['library_ms']:.4f} over {s['one_call_cases']} of {len(results)} cases (kernel "
            f"{s['ms_on_one_call_cases']:.4f} on them)")


def phase_transposed_entry_points(torch, tc, tb, card: str, against=None) -> dict:
    """Phase 15: the four entry points, with the launch counters set to 0
    just before and read just after; with ``against`` (another commit's
    kernels/), K6 and then K9 against its build there."""
    from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
        bisect_transposed, bisect_transposed2, bisect_transposed3, proto_transposed_cbr)
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        bound_ms, cbr_bytes, summed_bounds)

    tc.launches_v1 = tc.launches_v2 = 0
    tb.launches_k7 = tb.launches_k8 = tb.launches_k9 = 0
    print(f"[phase 15] on {card}: proto_transposed_cbr.main(['all'])")
    cbr = proto_transposed_cbr.main(["all"])["bench"]
    bisects = {}
    for kernel, script in (("K7", bisect_transposed), ("K8", bisect_transposed2),
                           ("K9", bisect_transposed3)):
        print(f"[phase 15] on {card}: {script.__name__.rsplit('.', 1)[-1]}.main([])")
        bisects[kernel] = script.main([])
    launches = {"transposed_cbr_v1": tc.launches_v1, "transposed_cbr_v2": tc.launches_v2,
                "transposed_bisect_K7": tb.launches_k7, "transposed_bisect_K8": tb.launches_k8,
                "transposed_bisect_K9": tb.launches_k9}
    print(f"[phase 15] kernel launches through the entry points: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the entry points never launched {name}")
    bound6 = bound_ms(cbr_bytes(*cbr["shape"]), cbr["flops"])
    out = {
        "transposed_cbr_v1": {"ms": cbr["v1"]["ms"], "plain_ms": cbr["plain_ms"],
                              "library_ms": None, **bound6},
        "transposed_cbr_v2": {"ms": cbr["v2"]["ms"], "plain_ms": cbr["plain_ms"],
                              "library_ms": None, **bound6},
    }
    for kernel, results in bisects.items():
        # library_ms: the one PyTorch call summed over the cases that have one
        # (K8's body b and K9 have none), beside the kernel's ms on them
        out[f"transposed_bisect_{kernel}"] = {"ms": sum(r["ms"] for r in results),
                       "plain_ms": sum(r["plain_ms"] for r in results),
                       **summed_bounds(results), **one_call_summary(results)}
    for name in out:
        out[name]["launches"] = launches[name]
    print(f"[phase 15] on {card}: K6 at {cbr['shape']}: v1 {out['transposed_cbr_v1']['ms']:.3f} "
          f"ms, v2 {out['transposed_cbr_v2']['ms']:.3f} ms, plain {cbr['plain_ms']:.3f} ms, "
          f"bound {bound6['bound_ms']:.3f} ms ({bound6['bound_by']}; v1 at "
          f"{bound6['bound_ms'] / out['transposed_cbr_v1']['ms']:.1%} of it), the cuDNN conv "
          f"alone {cbr['conv_ms']:.3f} ms; permute copy "
          f"{cbr['permute_ms']:.3f} ms; summed device ms "
          + ", ".join(f"{k} {out[f'transposed_bisect_{k}']['ms']:.4f} vs plain "
                      f"{out[f'transposed_bisect_{k}']['plain_ms']:.4f}, one call "
                      f"{_one_call_sum(bisects[k])} (bound "
                      f"{out[f'transposed_bisect_{k}']['bound_ms']:.4f})" for k in bisects))
    if against:
        print(f"[phase 15] on {card}: proto_transposed_cbr.bench(other_dir={against!r}), K6 v1 "
              f"and v2 of the other build and of this one in turns")
        pair = proto_transposed_cbr.bench(other_dir=against)
        for tag in ("v1", "v2"):
            r = pair[f"{tag}_against"]
            print(f"[phase 15] on {card}: K6 {tag} at {pair['shape']}, in turns: other build "
                  f"{r['other_ms']:.3f} ms, this one {r['ms']:.3f} ms "
                  f"({r['other_ms'] / r['ms']:.2f}x); bound {bound6['bound_ms']:.3f} ms, the "
                  f"cuDNN conv alone {pair['conv_ms']:.3f} ms")
        del pair
        torch.cuda.empty_cache()
        from selectivenet_for_semantic_segmentation_binary_torch.scripts import bisect_against

        src = os.path.join(against, "transposed_bisect.cu")
        print(f"[phase 15] on {card}: bisect_against.run({src!r}, ('K9',)), K9 of the other "
              f"build and of this one in turns")
        pair = bisect_against.run(src, ("K9",))
        other_ms, this_ms = (sum(r[k] for r in pair) for k in ("other_ms", "ms"))
        print(f"[phase 15] on {card}: K9 over its {len(pair)} runs, in turns, cold L2: other "
              f"build {other_ms:.4f} ms, this one {this_ms:.4f} ms ({other_ms / this_ms:.2f}x)")
    return out


# phase 16: the serving path. Tolerances: a bf16 forward against the
# float32 forward of the same weights on the card (max |logit difference|
# over max |logit|, and the share of mask pixels that may flip); a bf16
# forward at another batch size against the same image alone
# (probabilities, and masks away from the cut-off by as much): cuDNN picks
# its algorithms by batch size, and two bf16 forwards of one image then
# differ by up to ~1e-2 in probability, about as much as either differs
# from the float32 forward (1.5e-2 on the 2048x2048 slide); the bound is
# twice that; the float32 tiled path against the float32 whole image
# (probabilities).
SERVE_SEED = SEED + 16
SLIDE = 2048
SERVE_LOGIT_TOL = 0.05
SERVE_FLIP_MAX = 0.01
SERVE_PROB_TOL = 3e-2
SERVE_F32_TOL = 1e-4
SERVE_SIZES = ((256, 256), (250, 250), (300, 200))
SERVE_CLIENTS, SERVE_EACH = 8, 4


@contextlib.contextmanager
def float32_convs(torch):
    """True float32 convs and matmuls (no TF32) for the references."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _http(url, data=None):
    import urllib.request

    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _hold_to_alone(predictor, image, res, what: str) -> float:
    """A served result against ``predictor.predict`` of the image alone:
    probabilities within SERVE_PROB_TOL, masks equal SERVE_PROB_TOL away
    from the cut-off. Returns the largest |prob difference|."""
    from selectivenet_for_semantic_segmentation_binary_torch.tools.predict import _pad_to_grid

    padded, h, w = _pad_to_grid(np.asarray(image))
    alone = {k: v[0, :h, :w] for k, v in predictor.predict(padded[None]).items()}
    err = 0.0
    for prob, mask in (("prob", "pred"), ("selection_prob", "selection")):
        if res[prob].shape != (h, w):
            raise AssertionError(f"{what}: {prob} of shape {res[prob].shape}, not {(h, w)}")
        err = max(err, float(np.abs(res[prob] - alone[prob]).max()))
        away = np.abs(alone[prob] - 0.5) >= SERVE_PROB_TOL
        if not np.array_equal(res[mask][away], alone[mask][away]):
            raise AssertionError(f"{what}: {mask} differs from the image alone away from "
                                 f"the cut-off")
    if err > SERVE_PROB_TOL:
        raise AssertionError(f"{what}: max |prob - alone| {err:.3e} > {SERVE_PROB_TOL}")
    return err


def serving_state(torch, seed: int) -> dict:
    """The state dict of a seeded full-width selective UNet_B whose BN
    statistics lie well away from the identity, so that folding does real
    work (phases 16 and 17)."""
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        seeded_model)

    model = seeded_model(seed, "float32")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.state_dict()


def phase_serving(torch, device, card: str) -> dict:
    """Phase 16: the serving path on the card, from a checkpoint file to
    HTTP answers, at full width (the selective UNet_B in bfloat16, BN
    folded). Returns its times."""
    import importlib.util
    import threading

    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import (
        device_ingest, normalize_raw)
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        median_ms_device)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.serve import (
        PredictionService, make_server)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches)

    state = serving_state(torch, SERVE_SEED)
    ref = build_model("UNet_B", selective=True, compute_dtype="float32")
    load_weights(ref, state)
    ref.to(device)

    def reference(x_u8):
        """The float32 unfolded forward on the card: (output, select) logits."""
        with torch.inference_mode(), float32_convs(torch):
            return ref(normalize_raw(x_u8).permute(0, 3, 1, 2))[:2]

    images = InMemoryPatches(BATCH, SIZE, SERVE_SEED).inputs
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as d:
        path = os.path.join(d, "model_epoch1.pth")
        torch.save({"net": state}, path)
        folded = Predictor(path, selective=True, device=device)
        unfolded = Predictor(path, selective=True, fold_bn=False, device=device)
        folded32 = Predictor(path, selective=True, compute_dtype="float32", device=device)
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.model.modules()):
        raise AssertionError("the folded Predictor kept a BatchNorm")

    # folding: both bf16 Predictors against the float32 unfolded forward
    x = device_ingest(images, device)
    want = reference(x)
    scale = float(want[0].abs().max())
    want_mask = torch.sigmoid(want[0]) > 0.5
    near_cut = (torch.sigmoid(want[0]) - 0.5).abs() < 1e-2
    for name, p in (("fold_bn=True", folded), ("fold_bn=False", unfolded)):
        with torch.inference_mode():
            got = p._forward(x)
        err = max(float((gh - wh).abs().max()) for gh, wh in zip(got[:2], want))
        mean_err = float((got[0] - want[0]).abs().mean())
        flips = (torch.sigmoid(got[0]) > 0.5) != want_mask
        n_flip = int(flips.sum())
        n_near = int((flips & near_cut).sum())
        print(f"[phase 16] Predictor({name}) bf16 logits vs the float32 unfolded forward on "
              f"the card, {BATCH}x{SIZE}x{SIZE}: max |diff| {err:.4e} (max |logit| "
              f"{scale:.4e}; tolerance {SERVE_LOGIT_TOL} x max |logit|), mean |diff| "
              f"{mean_err:.4e}; mask pixels that differ {n_flip} of {flips.numel()} "
              f"({n_flip / flips.numel():.3e}; tolerance {SERVE_FLIP_MAX}), of them within "
              f"1e-2 of the cut-off: {n_near}"
              f" ({n_near / max(n_flip, 1):.1%})")
        if not err <= SERVE_LOGIT_TOL * scale or n_flip > SERVE_FLIP_MAX * flips.numel():
            raise AssertionError(f"Predictor({name}) disagrees with the float32 forward")
        del got, flips
    del want, want_mask, near_cut

    # predict against predict_compact: the same masks bit for bit
    full = folded.predict(images)
    for want_prob in (True, False):
        comp = folded.predict_compact(images, want_prob=want_prob)
        for mask in ("pred", "selection"):
            if not np.array_equal(comp[mask], full[mask]):
                raise AssertionError(f"predict_compact(want_prob={want_prob})[{mask!r}] != "
                                     f"predict()[{mask!r}]")
        if want_prob:
            for u8, prob in (("prob_u8", "prob"), ("selection_prob_u8", "selection_prob")):
                d8 = np.abs(comp[u8].astype(np.int64)
                            - np.round(full[prob].astype(np.float64) * 255)).max()
                if d8 > 1:
                    raise AssertionError(f"{u8} is {d8} from round({prob} * 255)")
        elif set(comp) != {"pred", "selection"}:
            raise AssertionError(f"masks-only predict_compact returned {sorted(comp)}")
    print(f"[phase 16] predict_compact == predict on {BATCH} patches: pred and selection "
          f"bit-equal (both graphs), prob_u8 within 1 of round(prob * 255); tumor fraction "
          f"{full['pred'].mean():.4f}, coverage {full['selection'].mean():.4f}")
    del full, comp

    # tiling: predict_wsi against one whole-image float32 forward of the slide
    slide = InMemoryPatches(1, SLIDE, SERVE_SEED).inputs[0]
    whole = [torch.sigmoid(o[0]).cpu().numpy() for o in reference(device_ingest(slide[None],
                                                                                  device))]
    with float32_convs(torch):
        tiled32 = folded32.predict_wsi(slide, tile=(512, 512), batch_size=8)
    tiled = folded.predict_wsi(slide, tile=(512, 512), batch_size=8)
    for name, got, tol in (("float32", tiled32, SERVE_F32_TOL), ("bf16", tiled, None)):
        err = float(np.abs(got["prob"] - whole[0]).max())
        n_flip = int((got["pred"] != (whole[0] > 0.5)).sum())
        n_sel = int((got["selection"] != (whole[1] > 0.5)).sum())
        print(f"[phase 16] predict_wsi {SLIDE}x{SLIDE} (tile 512, batch 8), {name} folded vs "
              f"the float32 whole-image forward: max |prob diff| {err:.4e}"
              + (f" (tolerance {tol})" if tol else "")
              + f"; mask pixels that differ {n_flip}, selection {n_sel} of {SLIDE * SLIDE}")
        if tol and err > tol:
            raise AssertionError("the float32 tiled path is not the whole-image forward")
        if n_flip > SERVE_FLIP_MAX * SLIDE * SLIDE:
            raise AssertionError(f"the {name} tiled mask disagrees with the whole image")
    times["wsi_ms"] = median_ms(lambda: folded.predict_wsi(slide, tile=(512, 512),
                                                            batch_size=8), runs=5, warmup=1)
    print(f"[phase 16] on {card}: predict_wsi of the {SLIDE}x{SLIDE} uint8 slide, bf16, "
          f"tile 512, batch 8: {times['wsi_ms']:.3f} ms median of 5 (host wall, ingest to "
          f"the masks on the host)")
    del whole, tiled32, tiled, folded32
    torch.cuda.empty_cache()

    # the service: 8 clients x 4 requests of mixed off-grid sizes and both dtypes
    crops = InMemoryPatches(SERVE_CLIENTS * SERVE_EACH, 304, SERVE_SEED + 1).inputs
    jobs = []
    for i in range(SERVE_CLIENTS * SERVE_EACH):
        h, w = SERVE_SIZES[i % len(SERVE_SIZES)]
        img = crops[i, :h, :w]
        jobs.append(img if (i // len(SERVE_SIZES)) % 2 == 0
                    else img.astype(np.float32) / 255.0)
    results = [None] * len(jobs)
    service = PredictionService(folded, max_batch=8)

    def client(c):
        for i in range(c, len(jobs), SERVE_CLIENTS):
            results[i] = service.predict_one(jobs[i])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("a service client did not finish in 300 s")
    stats = dict(service.stats.as_dict())
    worst = max(_hold_to_alone(folded, jobs[i], results[i], f"request {i}")
                for i in range(len(jobs)))
    print(f"[phase 16] PredictionService(max_batch=8): {SERVE_CLIENTS} threads x "
          f"{SERVE_EACH} requests of {SERVE_SIZES} in uint8 and float32: every answer == "
          f"predict() of its image alone (max |prob diff| {worst:.3e}, tolerance "
          f"{SERVE_PROB_TOL}; masks equal as far from the cut-off); stats {stats}")
    if not (stats["n_requests"] == len(jobs) and stats["n_batches"] < stats["n_requests"]
            and stats["n_errors"] == 0):
        raise AssertionError(f"the service did not batch {len(jobs)} requests cleanly: {stats}")

    # HTTP: healthz, a POSTed PNG, info and metrics agreeing, a clean shutdown
    server = make_server(service, "127.0.0.1", 0, model_info={"model_arch": "UNet_B",
                                                             "selective": True})
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(_http(url + "/healthz")[1])
        if health["backend"] != "cuda":
            raise AssertionError(f"/healthz says {health}")
        if importlib.util.find_spec("PIL") is None:
            print("[phase 16] POST /predict not run: Pillow is not installed here")
        else:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(jobs[1]).save(buf, format="PNG")
            code, body = _http(url + "/predict?format=npz", buf.getvalue())
            maps = dict(np.load(io.BytesIO(body)))
            err = _hold_to_alone(folded, jobs[1], maps, "POST /predict?format=npz")
            print(f"[phase 16] POST /predict?format=npz of a {jobs[1].shape[0]}x"
                  f"{jobs[1].shape[1]} PNG: {code}, {sorted(maps)}, max |prob diff| vs "
                  f"the image alone {err:.3e}")
        info = json.loads(_http(url + "/info")[1])["stats"]
        metrics = dict(line.split() for line in _http(url + "/metrics")[1].decode().splitlines()
                       if line and not line.startswith("#"))
        pairs = (("n_requests", "snet_requests_total"), ("n_batches", "snet_batches_total"),
                 ("n_errors", "snet_errors_total"), ("n_rejected", "snet_rejected_total"))
        if any(float(metrics[m]) != info[k] for k, m in pairs):
            raise AssertionError(f"/info {info} and /metrics {metrics} disagree")
        print(f"[phase 16] HTTP on {url}: /healthz {health}; /info and /metrics agree: "
              + ", ".join(f"{k} {info[k]}" for k, _ in pairs))
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=30)
    if serving.is_alive():
        raise AssertionError("the HTTP server did not shut down")

    # times
    with torch.inference_mode():
        u1 = median_ms_device(lambda: unfolded._forward(x))
        f1 = median_ms_device(lambda: folded._forward(x))
        f2 = median_ms_device(lambda: folded._forward(x))
        u2 = median_ms_device(lambda: unfolded._forward(x))
    times["folded_fwd_ms"], times["unfolded_fwd_ms"] = (f1 + f2) / 2, (u1 + u2) / 2
    print(f"[phase 16] on {card}: forward at batch {BATCH}, {SIZE}x{SIZE}, bf16, uint8 in "
          f"(device medians of 20, in turns): fold_bn=True {times['folded_fwd_ms']:.3f} ms "
          f"({f1:.3f}/{f2:.3f}), fold_bn=False {times['unfolded_fwd_ms']:.3f} ms "
          f"({u1:.3f}/{u2:.3f}); {times['unfolded_fwd_ms'] / times['folded_fwd_ms']:.3f}x")
    del x
    p1 = median_ms(lambda: folded.predict(images))
    c1 = median_ms(lambda: folded.predict_compact(images))
    c2 = median_ms(lambda: folded.predict_compact(images))
    p2 = median_ms(lambda: folded.predict(images))
    times["predict_ms"], times["compact_ms"] = (p1 + p2) / 2, (c1 + c2) / 2
    print(f"[phase 16] on {card}: a batch of {BATCH} uint8 patches, host wall (ingest, "
          f"forward, D2H; medians of 20, in turns): predict {times['predict_ms']:.3f} ms "
          f"({p1:.3f}/{p2:.3f}; {BATCH / times['predict_ms'] * 1e3:.1f} patches/s), "
          f"predict_compact {times['compact_ms']:.3f} ms ({c1:.3f}/{c2:.3f}; "
          f"{BATCH / times['compact_ms'] * 1e3:.1f} patches/s)")
    one = jobs[0]
    service.warmup(SIZE, SIZE, 3, dtype=np.uint8)
    lat = []
    for _ in range(WARMUP + RUNS):
        t0 = time.perf_counter()
        service.predict_one(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    times["request_p50_ms"] = statistics.median(lat[WARMUP:])
    n_each = 32
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda: [service.predict_one(one) for _ in range(n_each)])
               for _ in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("a throughput client did not finish in 300 s")
    wall = time.perf_counter() - t0
    times["service_patches_per_s"] = SERVE_CLIENTS * n_each / wall
    stats = service.stats.as_dict()
    service.close()
    print(f"[phase 16] on {card}: one {SIZE}x{SIZE} request alone through the service "
          f"(batch window 5 ms): p50 {times['request_p50_ms']:.3f} ms of {RUNS}; "
          f"{SERVE_CLIENTS} concurrent clients x {n_each} requests: "
          f"{times['service_patches_per_s']:.1f} patches/s ({wall:.3f} s; mean occupancy "
          f"{stats['mean_occupancy']:.2f} over {stats['n_batches']} batches in all)")
    if stats["n_errors"]:
        raise AssertionError(f"the service reported errors: {stats}")
    del ref, folded, unfolded
    torch.cuda.empty_cache()
    return times


ANALYSIS_SEED = SEED + 17
ANALYSIS_SLIDES, ANALYSIS_TEST_SLIDES, ANALYSIS_PER_SLIDE, ANALYSIS_NROW = 78, 4, 18, 3
ANALYSIS_MIN_VALID = 256
# phase 16's bound: its bf16 logits lay within 8.6e-2 of float32, at most
# 2.2e-2 after the sigmoid
ANALYSIS_PROB_TOL = 3e-2
ANALYSIS_SCORE_TOL = 1e-12  # float64 recomputation; the AUC by the rank formula
ANALYSIS_COVERAGE = 0.8
MC_RATE, MC_KEEP_TOL = 0.1, 0.005
TRAIN_TIMING_RUNS = 5


def _write_analysis_tree(d: str, n_slides: int = ANALYSIS_SLIDES,
                         test_slides: int = ANALYSIS_TEST_SLIDES) -> None:
    """The port's synthetic patch tree, with the fold lists dealt again so
    that fold 1 holds slides 0 to ``test_slides - 1`` whole (the writer
    deals each class's patches round-robin over the folds, which scatters a
    slide) and folds 2-5 the other slides' patches round-robin."""
    import re

    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        write_synthetic_patch_tree)

    write_synthetic_patch_tree(d, n_slides=n_slides, patches_per_slide=ANALYSIS_PER_SLIDE,
                               patch_size=SIZE, seed=ANALYSIS_SEED)

    def key(pair):  # (slide, x) of {slide}_{x}_{y}_input.jpg
        return tuple(int(v) for v in re.match(r"slide(\d+)_(\d+)_", pair[0]).groups())

    for cls in ("tumorable", "non_tumorable"):
        pairs = sorted((tuple(p) for i in range(1, 6)
                        for p in np.load(os.path.join(d, f"{i}-fold_{cls}_data.npy"))), key=key)
        test = [p for p in pairs if key(p)[0] < test_slides]
        rest = [p for p in pairs if key(p)[0] >= test_slides]
        for fold, lst in [(1, test)] + [(i + 2, rest[i::4]) for i in range(4)]:
            arr = np.array(lst) if lst else np.empty((0, 2), dtype="<U64")
            np.save(os.path.join(d, f"{fold}-fold_{cls}_data.npy"), arr)


def _scores64(label, prob, pred):
    """get_performance's five numbers recomputed in float64 from the arrays,
    the AUC by the rank (Mann-Whitney) formula with tied scores at their
    mean rank."""
    lab = np.ravel(label).astype(np.int64)
    prd = np.ravel(pred).astype(np.int64)
    score = np.ravel(prob)
    c1, c0 = int((lab == 1).sum()), int((lab == 0).sum())
    tp, tn = int(((lab == 1) & (prd == 1)).sum()), int(((lab == 0) & (prd == 0)).sum())
    p1 = int((prd == 1).sum())
    acc = (tp + tn) / (c1 + c0)
    rec = tp / c1 if c1 else math.nan
    prec = tp / p1 if p1 else math.nan
    f1 = (2 * rec * prec / (rec + prec)
          if math.isfinite(rec) and math.isfinite(prec) and rec + prec else math.nan)
    auc = math.nan
    if c1 and c0:
        order = np.argsort(score, kind="stable")
        s = score[order]
        starts = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1]
        ends = np.r_[starts[1:], s.size]
        ranks = np.empty(s.size)
        ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
        auc = (ranks[lab == 1].sum() - c1 * (c1 + 1) / 2.0) / (c1 * c0)
    return np.array([acc, rec, prec, f1, auc], np.float64)


def _same_scores(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not (np.array_equal(np.isnan(got), np.isnan(want))
            and np.all(np.abs(np.nan_to_num(got) - np.nan_to_num(want)) <= ANALYSIS_SCORE_TOL)):
        raise AssertionError(f"{what}: {got} != float64 recomputation {want}")


def phase_analysis(torch, fc, device, card: str) -> dict:
    """Phase 17: the analysis path at full width, the selective UNet_B in
    bfloat16 from a seeded ``.pth``: ``snet-wsi`` over a test fold of four
    whole slides, ``snet-calibrate`` on the validation split, MC-dropout
    uncertainty through the Predictor and ``snet-predict``, and train steps
    with dropout on both trunks. Returns its times and K2's launches."""
    import csv
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from selectivenet_for_semantic_segmentation_binary_torch import cli
    from selectivenet_for_semantic_segmentation_binary_torch.config import (
        EvalConfig, TrainConfig)
    from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
    from selectivenet_for_semantic_segmentation_binary_torch.data.folds import (
        construct_test, construct_train_valid)
    from selectivenet_for_semantic_segmentation_binary_torch.data.loader import PatchLoader
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import make_eval_loader
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import (
        device_ingest, normalize_raw)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import CBR_LAYERS
    from selectivenet_for_semantic_segmentation_binary_torch.tools import calibrate, wsi
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        device_preprocess, make_train_step)
    from selectivenet_for_semantic_segmentation_binary_torch.utils.metrics import (
        get_performance)

    fc.launches = 0
    times = {}
    state = serving_state(torch, ANALYSIS_SEED)
    ref = load_weights(build_model("UNet_B", selective=True, compute_dtype="float32"),
                       state).to(device)
    bf16 = load_weights(build_model("UNet_B", selective=True, compute_dtype="bfloat16"),
                        state).to(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as d:
        t0 = time.perf_counter()
        _write_analysis_tree(d)
        model_dir = os.path.join(d, "models")
        os.makedirs(model_dir)
        path = os.path.join(model_dir, "model_epoch1.pth")
        torch.save({"net": state}, path)
        test_list = construct_test(d, test_fold=1)
        _train, valid_list = construct_train_valid(d, test_fold=1, seed=42)
        print(f"[phase 17] data: {ANALYSIS_SLIDES} slides x {ANALYSIS_PER_SLIDE} patches of "
              f"{SIZE}x{SIZE} written in {time.perf_counter() - t0:.2f} s; test fold 1: "
              f"{len(test_list)} patches, validation split of folds 2-5: {len(valid_list)}")
        if (len(test_list) != ANALYSIS_TEST_SLIDES * ANALYSIS_PER_SLIDE
                or len(valid_list) < ANALYSIS_MIN_VALID):
            raise AssertionError("the analysis tree has the wrong fold sizes")

        # snet-wsi
        out_dir = os.path.join(d, "wsi")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            results = cli.main(["wsi", "--data_dir", d, "--model_dir", model_dir,
                                "--selective", "1", "--nrow", str(ANALYSIS_NROW),
                                "--batch_size", "32", "--patch_size", str(SIZE),
                                "--num_workers", "8", "--save_dir", out_dir], device=device)
        wsi_wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            print(f"[phase 17] snet-wsi | {line}")
        ds = PatchDataset(d, test_list, 200, SIZE)
        groups = wsi._group_by_slide([n.split("_input")[0] for n in ds.input_list])
        if list(results) != list(groups) or len(results) != ANALYSIS_TEST_SLIDES:
            raise AssertionError(f"snet-wsi scored {list(results)}, want {list(groups)}")
        worst = n_flip = n_pix = 0
        raw = {}
        for slide, idx in groups.items():
            x, labels = map(np.stack, zip(*(ds.get_raw(i) for i in idx)))
            raw[slide] = (x, labels)
            with torch.inference_mode(), float32_convs(torch):
                want = torch.sigmoid(ref(normalize_raw(device_ingest(x, device))
                                         .permute(0, 3, 1, 2))[0]).cpu().numpy()
            want_c = wsi.stitch_patches(want, ANALYSIS_NROW)
            r = results[slide]
            worst = max(worst, float(np.abs(r["prob"] - want_c).max()))
            flips = r["pred"] != (want_c > 0.5)
            if np.any(np.abs(want_c[flips] - 0.5) >= ANALYSIS_PROB_TOL):
                raise AssertionError(f"{slide}: a mask pixel flipped away from the cut-off")
            n_flip += int(flips.sum())
            n_pix += flips.size
            np.testing.assert_array_equal(r["label"], wsi.stitch_patches(labels, ANALYSIS_NROW))
            _same_scores(r["wsi_score"], _scores64(r["label"], r["prob"], r["pred"]),
                         f"{slide} wsi_score")
            for j in range(len(idx)):
                row, col = j % ANALYSIS_NROW, j // ANALYSIS_NROW
                cell = (slice(row * SIZE, (row + 1) * SIZE), slice(col * SIZE, (col + 1) * SIZE))
                _same_scores(r["patch_scores"][j],
                             _scores64(r["label"][cell], r["prob"][cell], r["pred"][cell]),
                             f"{slide} patch {j}")
            if not math.isfinite(r["wsi_score"][4]):
                raise AssertionError(f"{slide}: the stitched AUC is NaN")
            for f in (f"{slide}_heatmap.png", f"{slide}_pred.png"):
                if not os.path.exists(os.path.join(out_dir, f)):
                    raise AssertionError(f"snet-wsi did not write {f}")
        with open(os.path.join(out_dir, "wsi_performance.csv")) as f:
            rows = list(csv.reader(f))
        if [r[0] for r in rows[1:]] != list(results) or any(r[5] == "nan" for r in rows[1:]):
            raise AssertionError(f"wsi_performance.csv: {rows}")
        print(f"[phase 17] snet-wsi: {len(results)} slides of {ANALYSIS_PER_SLIDE} patches "
              f"({ANALYSIS_NROW}x{ANALYSIS_PER_SLIDE // ANALYSIS_NROW} grids), bf16 vs the "
              f"float32 forward on the card: max |prob diff| {worst:.4e} (tolerance "
              f"{ANALYSIS_PROB_TOL}); mask pixels that differ {n_flip} of {n_pix}, all within "
              f"{ANALYSIS_PROB_TOL} of the cut-off; wsi_score and the {len(test_list)} "
              f"patch_scores rows == a float64 recomputation (AUC by the rank formula) within "
              f"{ANALYSIS_SCORE_TOL}; {len(rows) - 1} CSV rows, no AUC NaN, the PNGs written")
        if worst > ANALYSIS_PROB_TOL:
            raise AssertionError("snet-wsi's probabilities disagree with the float32 forward")

        x0 = raw[next(iter(raw))][0]

        def slide_forward():
            outs = [wsi._wsi_forward(bf16, device_ingest(x0[i:i + 32], device), True)
                    for i in range(0, len(x0), 32)]
            return torch.cat(outs).float().cpu().numpy()

        prob0 = slide_forward()
        lab0 = raw[next(iter(raw))][1]
        pool = ThreadPoolExecutor(max_workers=8)

        def slide_scoring():
            pred = (prob0 > 0.5).astype(np.uint8)
            list(pool.map(lambda j: get_performance(lab0[j], prob0[j], pred[j]),
                          range(len(prob0))))
            canv = [wsi.stitch_patches(a, ANALYSIS_NROW)
                    for a in (prob0, pred, lab0, x0.astype(np.float32) / 255.0)]
            get_performance(canv[2], canv[0], canv[1])
            wsi.make_heatmap(canv[0])

        # the same CLI again, the card warm: the wall a slide without the
        # first call's set-up
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["wsi", "--data_dir", d, "--model_dir", model_dir, "--selective", "1",
                      "--nrow", str(ANALYSIS_NROW), "--batch_size", "32", "--patch_size",
                      str(SIZE), "--num_workers", "8", "--save_dir", out_dir + "_warm"],
                     device=device)
        warm_wall = time.perf_counter() - t0
        times["wsi_slide_ms"] = wsi_wall * 1e3 / len(results)
        times["wsi_slide_warm_ms"] = warm_wall * 1e3 / len(results)
        times["wsi_forward_ms"] = median_ms(slide_forward, runs=5, warmup=1)
        times["wsi_scoring_ms"] = median_ms(slide_scoring, runs=5, warmup=1)
        pool.shutdown()
        print(f"[phase 17] on {card}: snet-wsi {times['wsi_slide_ms']:.3f} ms a slide of "
              f"{ANALYSIS_PER_SLIDE} patches in the first call (CLI wall {wsi_wall:.3f} s for "
              f"{len(results)} slides: checkpoint, decode, forward, scoring, PNGs, CSV), "
              f"{times['wsi_slide_warm_ms']:.3f} ms in a second ({warm_wall:.3f} s); of a slide "
              f"the forward {times['wsi_forward_ms']:.3f} ms (uint8 in, bf16, probabilities "
              f"on the host) and the scoring {times['wsi_scoring_ms']:.3f} ms (18 patch scores "
              f"on 8 threads, 4 canvases, the stitched score, the heatmap), host medians of 5")

        # snet-calibrate on the validation split
        csv_path = os.path.join(d, "rc.csv")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.main(["calibrate", "--data_dir", d, "--fold", "1", "--model_dir",
                            model_dir, "--patch_size", str(SIZE), "--batch_size", str(BATCH),
                            "--split", "valid", "--target_coverage", str(ANALYSIS_COVERAGE),
                            "--curve_csv", csv_path], device=device)
        cal_wall = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            print(f"[phase 17] snet-calibrate | {line}")
        cfg = EvalConfig(data_dir=d, test_fold=1, model_dir=model_dir, selective=True,
                         select_eval=True, patch_size=SIZE, batch_size=BATCH)
        total = len(valid_list) * SIZE * SIZE
        hist = calibrate._accumulate(make_eval_loader(cfg, device, data_list=valid_list),
                                     calibrate.make_histogram_step(bf16, 2))
        hist2d = calibrate.risk_coverage_curve(cfg, data_list=valid_list, verbose=False,
                                               device=device)["histogram2d"]
        if not (hist.sum() == total == res["n_pixels"]
                and np.array_equal(hist2d.sum(axis=1), hist)):
            raise AssertionError(f"histograms: {hist.sum()}, {hist2d.sum()}, {res}, want {total}")
        cov = np.cumsum(hist[::-1])[::-1] / total
        b = int(round(res["s_cut_off"] * calibrate.N_BINS))
        if not (res["achieved_coverage"] == cov[b] >= ANALYSIS_COVERAGE
                and (b == calibrate.N_BINS - 1 or cov[b + 1] < ANALYSIS_COVERAGE)):
            raise AssertionError(f"coverage {res} is not the request within one bin")
        g = []
        with torch.inference_mode():
            for batch in make_eval_loader(cfg, device, data_list=valid_list):
                x, label = device_preprocess(batch)
                g.append(torch.sigmoid(bf16(x)[1].float())[label < 2])
        g = torch.sort(torch.cat(g), descending=True).values
        k = math.ceil(ANALYSIS_COVERAGE * g.numel())
        t_sort = math.floor(float(g[k - 1]) * calibrate.N_BINS) / calibrate.N_BINS
        with open(csv_path) as f:
            n_rows = sum(1 for _ in f)
        print(f"[phase 17] snet-calibrate: {len(valid_list)} validation patches, "
              f"{total} pixels == the histogram's total == the 2-D histogram's; the 1-D "
              f"histogram == the 2-D one's marginal; --s_cut_off {res['s_cut_off']:.6f} gives "
              f"coverage {res['achieved_coverage']:.6f} >= {ANALYSIS_COVERAGE} (the next bin "
              f"{cov[min(b + 1, calibrate.N_BINS - 1)]:.6f}); from a sort of g of a separate "
              f"forward {t_sort:.6f} (tolerance 1/{calibrate.N_BINS}); curve CSV {n_rows} lines")
        if abs(res["s_cut_off"] - t_sort) > 1 / calibrate.N_BINS or n_rows != calibrate.N_BINS + 1:
            raise AssertionError("the calibrated threshold disagrees with the sorted g")
        times["calibrate_s"] = cal_wall
        times["calibrate_patches_per_s"] = len(valid_list) / cal_wall
        print(f"[phase 17] on {card}: snet-calibrate --split valid --curve_csv, batch {BATCH}: "
              f"{cal_wall:.3f} s wall ({times['calibrate_patches_per_s']:.1f} patches/s; "
              f"checkpoint, decode, forward, histograms, CSV)")
        del g, hist, hist2d

        # MC-dropout
        images8 = x0[:8]
        zero = Predictor(path, selective=True, device=device)
        u = zero.predict_with_uncertainty(images8, n_iter=4)
        err = float(np.abs(u["mean_prob"][..., 0] - zero.predict(images8)["prob"]).max())
        if u["variance"].any() or err > 1e-6:
            raise AssertionError(f"dropout_rate=0: variance max {u['variance'].max()}, "
                                 f"mean_prob vs predict {err}")
        mc = Predictor(path, selective=True, dropout_rate=MC_RATE, device=device)
        counts = {}

        def count_kept(name):
            def hook(module, args, out):
                live = args[0] != 0
                c = counts.setdefault(name, [0, 0])
                c[0] += int((live & (out != 0)).sum())
                c[1] += int(live.sum())
            return hook

        hooks = [getattr(mc.model, n).register_forward_hook(count_kept(n))
                 for n in ("drop_bottom", "drop3")]
        try:
            a = mc.predict_with_uncertainty(images8, n_iter=32, seed=0)
        finally:
            for h in hooks:
                h.remove()
        again = mc.predict_with_uncertainty(images8, n_iter=32, seed=0)
        other = mc.predict_with_uncertainty(images8, n_iter=32, seed=1)
        kept = {n: c[0] / c[1] for n, c in counts.items()}
        same = all(np.array_equal(a[k], again[k]) for k in a)
        print(f"[phase 17] MC-dropout: rate 0, n_iter 4: variance 0, mean_prob == predict's "
              f"prob within {err:.1e}; rate {MC_RATE}, n_iter 32, 8 patches: max variance "
              f"{a['variance'].max():.4e}, mean {a['variance'].mean():.4e}; seed 0 twice "
              f"bit-equal {same}, seed 1 differs {not np.array_equal(a['variance'], other['variance'])}; "
              f"kept fraction " + ", ".join(f"{n} {v:.5f}" for n, v in kept.items())
              + f" (want {1 - MC_RATE} within {MC_KEEP_TOL})")
        if not (a["variance"].max() > 0 and same
                and not np.array_equal(a["variance"], other["variance"])
                and set(kept) == {"drop_bottom", "drop3"}
                and all(abs(v - (1 - MC_RATE)) <= MC_KEEP_TOL for v in kept.values())):
            raise AssertionError("MC-dropout failed its checks")
        from PIL import Image

        img_path = os.path.join(d, "mc_patch.png")
        Image.fromarray(x0[0]).save(img_path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["predict", img_path, "--model_path", path, "--selective", "1",
                      "--uncertainty", "8", "--dropout_rate", str(MC_RATE),
                      "--save_dir", os.path.join(d, "mc")], device=device)
        written = sorted(os.listdir(os.path.join(d, "mc")))
        print(f"[phase 17] snet-predict --uncertainty 8: {buf.getvalue().splitlines()[-1]}; "
              f"wrote {written}")
        if not {"mc_patch_uncertainty.npz", "mc_patch_variance.png"} <= set(written):
            raise AssertionError("snet-predict --uncertainty did not write its files")
        images128 = InMemoryPatches(BATCH, SIZE, ANALYSIS_SEED).inputs
        for n, imgs, n_iter in ((8, images8, 32), (BATCH, images128, 8)):
            m1 = median_ms(lambda: mc.predict_with_uncertainty(imgs, n_iter=n_iter), 3, 1)
            c1 = median_ms(lambda: mc.predict_compact(imgs), 5, 1)
            c2 = median_ms(lambda: mc.predict_compact(imgs), 5, 1)
            m2 = median_ms(lambda: mc.predict_with_uncertainty(imgs, n_iter=n_iter), 3, 1)
            times[f"mc_fwd_ms_b{n}"] = (m1 + m2) / 2 / n_iter
            times[f"compact_ms_b{n}"] = (c1 + c2) / 2
            print(f"[phase 17] on {card}: mc_uncertainty at batch {n}, n_iter {n_iter}, bf16 "
                  f"folded: {times[f'mc_fwd_ms_b{n}']:.3f} ms a stochastic forward "
                  f"({m1:.3f}/{m2:.3f} ms a call, medians of 3); predict_compact at batch {n}: "
                  f"{times[f'compact_ms_b{n}']:.3f} ms ({c1:.3f}/{c2:.3f}, medians of 5); host "
                  f"wall, in turns")
        del zero, mc
    del ref
    torch.cuda.empty_cache()

    # train steps with dropout, both trunks
    cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit", batch_size=BATCH,
                      patch_size=SIZE, compute_dtype="bfloat16", dropout_rate=MC_RATE,
                      seed=SEED)
    batch = next(iter(PatchLoader(InMemoryPatches(BATCH, SIZE, ANALYSIS_SEED + 1), BATCH,
                                  num_workers=8, device=device, shuffle=True, drop_last=True,
                                  seed=SEED, random_flip=True)))
    steps, losses = {}, {}
    for fused in (True, False):
        for rate in (MC_RATE, 0.0):
            c = dataclasses.replace(cfg, dropout_rate=rate)
            model = load_weights(build_model("UNet_B", selective=True, compute_dtype="bfloat16",
                                             fused=fused, dropout_rate=rate), state).to(device)
            step = make_train_step(model, c, build_optimizer(c, model.parameters()))
            before = fc.launches
            losses[fused, rate] = float(step(batch, cfg.lr)["loss"])
            if fused and fc.launches - before != len(CBR_LAYERS):
                raise AssertionError(f"a fused train step launched fused_conv_stats "
                                     f"{fc.launches - before} times, want {len(CBR_LAYERS)}")
            steps[fused, rate] = step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fused in (True, False):
            steps[fused, MC_RATE](batch, cfg.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[phase 17] train step, batch {BATCH}, {SIZE}x{SIZE}, bf16: losses "
          + ", ".join(f"{'fused' if f else 'classic'} rate {r} {v:.6f}" for (f, r), v in losses.items())
          + f"; the fused trunk launched fused_conv_stats {len(CBR_LAYERS)} times a step with "
          f"dropout; one more dropout step of each trunk under set_sync_debug_mode('error'): "
          f"no host sync")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"a train step's loss is not finite: {losses}")
    order = list(steps) + list(reversed(steps))
    ms = {k: [] for k in steps}
    for k in order:
        ms[k].append(median_ms(lambda: steps[k](batch, 1e-3), TRAIN_TIMING_RUNS, 1))
    for fused in (True, False):
        on, off = statistics.mean(ms[fused, MC_RATE]), statistics.mean(ms[fused, 0.0])
        name = "fused" if fused else "classic"
        times[f"train_{name}_dropout_ms"], times[f"train_{name}_ms"] = on, off
        print(f"[phase 17] on {card}: train step, {name} trunk, batch {BATCH}, {SIZE}x{SIZE}, "
              f"bf16: --dropout_rate {MC_RATE} {on:.3f} ms "
              f"({'/'.join(f'{v:.3f}' for v in ms[fused, MC_RATE])}), rate 0 {off:.3f} ms "
              f"({'/'.join(f'{v:.3f}' for v in ms[fused, 0.0])}); {on / off:.3f}x (host medians "
              f"of {TRAIN_TIMING_RUNS}, in turns)")
    launches = fc.launches
    print(f"[phase 17] fused_conv_stats launches on the analysis path (counter set to 0 at its "
          f"start): {launches}")
    if launches == 0:
        raise AssertionError("the analysis path launched fused_conv_stats no time")
    del steps, batch, bf16
    torch.cuda.empty_cache()
    times["launches"] = launches
    return times


INPUTS_SEED = SEED + 18
# 800 JPEG/PNG pairs: folds 2-5 give 512 train patches (4 batches of 128) and 128
# validation patches; fold 1 160 test patches (2 eval batches)
INPUTS_SLIDES, INPUTS_PER_SLIDE = 50, 16
INPUTS_WORKERS = 16
INPUTS_STEP_TOL = 1e-2  # phase 7's: the trunks round to bf16 at different places
INPUTS_PROB_TOL = SERVE_PROB_TOL  # phase 16's
INPUTS_FEEDS = (  # (label, TrainConfig flags, decoder); the loaders decode with PIL
    ("RGB raw", {}, "pil"),
    ("RGB raw, native decoder", {}, "native"),  # where it builds on this host
    ("RGB --device_preproc 0", {"device_preproc": False}, "pil"),
    ("RGB --blankfield 1", {"blankfield": True}, "pil"),
    ("RGB --pnt_aug 1", {"pnt_aug": True}, "pil"),
    ("GH", {"input_type": "GH"}, "pil"),
    ("GH --blankfield 1", {"input_type": "GH", "blankfield": True}, "pil"),
    ("H_RGB", {"input_type": "H_RGB"}, "pil"),
)


def _flatten_tree(tree, prefix=""):
    """{"a/b/c": ndarray} of a decoded checkpoint's array leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def phase_inputs(torch, fc, em, device, card: str) -> dict:
    """Phase 18: the host input pipelines (GH and H_RGB stain inputs,
    blank-field correction, PNT, ``--device_preproc 0``, the native decoder)
    at full width, from a JPEG/PNG tree on disk: the feed alone, GH training
    with ``--fused_cbr on`` (K2) beside RGB, GH evaluation (K1), the three
    CLIs on a GH + blank-field checkpoint, and a JAX ``.ckpt`` read without
    depending on ``msgpack``. K1's and K2's counters are set to 0 at its start;
    K2's is read right after ``train()`` and K1's right after ``evaluate()``,
    before the comparison and timing runs. Returns its times and those
    launches."""
    import dataclasses
    import importlib.util

    from torch.profiler import ProfilerActivity, profile as tprofile

    from selectivenet_for_semantic_segmentation_binary_torch import cli
    from selectivenet_for_semantic_segmentation_binary_torch.config import (
        EvalConfig, TrainConfig)
    from selectivenet_for_semantic_segmentation_binary_torch.data import native_decoder
    from selectivenet_for_semantic_segmentation_binary_torch.data.dataset import PatchDataset
    from selectivenet_for_semantic_segmentation_binary_torch.data.folds import (
        construct_test, construct_train_valid)
    from selectivenet_for_semantic_segmentation_binary_torch.eval_lib import (
        evaluate, make_eval_loader)
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        UNetB, build_model, init_weights, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import (
        device_ingest, normalize_raw)
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import CBR_LAYERS
    from selectivenet_for_semantic_segmentation_binary_torch.tools import predict as predict_tool
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        _kernel_times)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        write_synthetic_patch_tree)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        _run_epoch, device_preprocess, make_loaders, make_train_step, train)
    from selectivenet_for_semantic_segmentation_binary_torch.utils.checkpoint import (
        load_flax_msgpack, load_net_checkpoint)

    t_phase = time.perf_counter()
    fc.launches = em.launches = 0
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inputs_") as d:
        t0 = time.perf_counter()
        write_synthetic_patch_tree(d, n_slides=INPUTS_SLIDES, patches_per_slide=INPUTS_PER_SLIDE,
                                   patch_size=SIZE, seed=INPUTS_SEED)
        train_list, valid_list = construct_train_valid(d, test_fold=1, seed=SEED)
        test_list = construct_test(d, test_fold=1)
        print(f"[phase 18] data: {INPUTS_SLIDES} slides x {INPUTS_PER_SLIDE} JPEG/PNG pairs of "
              f"{SIZE}x{SIZE} written in {time.perf_counter() - t0:.2f} s; fold 1: "
              f"{len(train_list)} train, {len(valid_list)} validation, {len(test_list)} test")
        if len(train_list) < 3 * BATCH:
            raise AssertionError("the tree gives fewer than 3 train batches")
        base = TrainConfig(data_dir=d, fold=1, model_arch="UNet_B", selective=True,
                           loss="BCElogit", batch_size=BATCH, patch_size=SIZE, n_epoch=1,
                           compute_dtype="bfloat16", fused_cbr="on",
                           num_workers=INPUTS_WORKERS, seed=SEED)

        # 1. the feed alone: one epoch of the train loader, no step
        native = native_decoder.available()
        print("[phase 18] decoder: PIL (the default); the native decoder "
              + ("built (kernels/_build/libpatch_decoder.so)" if native else
                 f"did not build here: {native_decoder.build_error()}"))
        # untimed: one epoch of the raw feed and one batch of a float feed, so
        # that the process's first pinned allocations and thread pools are
        # not charged to the first timed feed
        for flags, n_batches in (({}, None), ({"device_preproc": False}, 1)):
            for i, _ in enumerate(make_loaders(dataclasses.replace(base, **flags), device)[0]):
                if n_batches is not None and i + 1 >= n_batches:
                    break
        torch.cuda.synchronize()
        feeds = {}
        for label, flags, decoder in INPUTS_FEEDS:
            if decoder == "native" and not native:
                print(f"[phase 18] feed alone, {label}: skipped, the native decoder did not "
                      f"build here")
                continue
            cfg = dataclasses.replace(base, **flags)
            loader = make_loaders(cfg, device)[0]
            if decoder == "native":
                ds = loader.dataset
                loader.dataset = PatchDataset(d, list(zip(ds.input_list, ds.label_list)), 200,
                                              SIZE, cfg.input_type, transform=ds.transform,
                                              decoder="native")
            loader.set_epoch(1)
            n, shape, dtype = 0, None, None
            t0 = time.perf_counter()
            for b in loader:
                n += b["nvalid"]
                shape, dtype = tuple(b["input"].shape), b["input"].dtype
            torch.cuda.synchronize()
            rate = n / (time.perf_counter() - t0)
            feeds[label] = rate
            used = "native" if loader.dataset.use_native else "PIL"
            print(f"[phase 18] on {card}: feed alone, {label}: {rate:.1f} patches/s ({n} patches, "
                  f"batch {BATCH}, {INPUTS_WORKERS} workers, {used} decoder, batches {shape} "
                  f"{str(dtype).replace('torch.', '')}, into the card; one epoch, no step)")
        times["feeds"] = feeds

        # 2. GH training with the fused trunk: train() for one epoch, with
        # blank-field correction (the reference grid's GH_BC variant), whose
        # checkpoint items 3 and 4 read
        gh = dataclasses.replace(base, input_type="GH", blankfield=True,
                                 model_dir=os.path.join(d, "gh"))
        n_train, n_valid = (len(lo) for lo in make_loaders(gh, device))
        t0 = time.perf_counter()
        result = train(gh, verbose=False, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = len(CBR_LAYERS) * (n_train + n_valid)
        tr, va = result["train"], result["valid"]
        print(f"[phase 18] train() --input_type GH --blankfield 1 --fused_cbr on, 1 epoch "
              f"({n_train} train + "
              f"{n_valid} valid batches of {BATCH}, bf16): {wall:.3f} s wall (with set-up and "
              f"the checkpoint), train pass {tr.seconds:.3f} s = {tr.patches_per_sec:.1f} "
              f"patches/s; losses train {tr.loss:.6f} (aux {tr.aux_loss:.6f}, select "
              f"{tr.sel_loss:.6f}), valid {va.loss:.6f}; fused_conv_stats launches "
              f"{fc.launches} (want {len(CBR_LAYERS)} x {n_train + n_valid} = {want})")
        if fc.launches != want:
            raise AssertionError(f"GH training launched fused_conv_stats {fc.launches} times")
        k2_path = fc.launches  # the comparison and timing runs below are not the path's
        if not all(math.isfinite(v) and v >= 0 for v in
                   (tr.loss, tr.aux_loss, tr.sel_loss, va.loss, va.aux_loss, va.sel_loss)):
            raise AssertionError("GH training: a loss is not finite or negative")
        state = {k: v.detach().clone() for k, v in result["model"].state_dict().items()}
        if tuple(state["encoder_layer_1_1.0.weight"].shape) != (64, 2, 3, 3):
            raise AssertionError("the GH model's first conv does not take 2 channels")
        ckpt = os.path.join(gh.ckpt_dir, "model_epoch1.pth")
        del result

        # one GH step on the fused trunk against the classic trunk
        batch = next(iter(make_loaders(gh, device)[0]))
        losses = {}
        for fused in (True, False):
            m = load_weights(build_model("UNet_B", selective=True, compute_dtype="bfloat16",
                                         fused=fused, in_ch=2), state).to(device)
            before = fc.launches
            losses[fused] = float(make_train_step(m, gh, build_optimizer(gh, m.parameters()))(
                batch, gh.lr)["loss"])
            if fused and fc.launches - before != len(CBR_LAYERS):
                raise AssertionError("a fused GH step did not launch fused_conv_stats "
                                     f"{len(CBR_LAYERS)} times")
            del m
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        print(f"[phase 18] one GH train step from the same weights and batch: loss fused "
              f"{losses[True]:.6f} vs classic {losses[False]:.6f} (rel. diff {rel:.3e}, "
              f"tolerance {INPUTS_STEP_TOL}); the first layer (Cin 2) ran the plain dataflow, "
              f"the {len(CBR_LAYERS)} others fused_conv_stats")
        if not rel <= INPUTS_STEP_TOL:
            raise AssertionError("the fused and the classic trunk disagree on a GH step")

        # the train pass of an epoch, GH and RGB raw in turns: wall, patches/s
        # and the card's busy share (kernel time over the pass's wall)
        steppers = {}
        for it in ("GH", "RGB"):
            c = dataclasses.replace(base, input_type=it)
            m = build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=True,
                            in_ch=c.input_channels)
            init_weights(m, torch.Generator().manual_seed(SEED)).to(device)
            steppers[it] = (c, make_train_step(m, c, build_optimizer(c, m.parameters())))
        runs = {"GH": [], "RGB": []}
        for it in ("GH", "RGB", "RGB", "GH"):
            c, step = steppers[it]
            loader = make_loaders(c, device)[0]
            loader.set_epoch(2)
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                stats, _, _ = _run_epoch(c, loader, step, c.lr, train=True)
            kernel_us = sum(_kernel_times(prof)[0].values())
            runs[it].append((stats.seconds, stats.patches_per_sec,
                             kernel_us / (stats.seconds * 1e6)))
            print(f"[phase 18] on {card}: train pass, {it}{' raw' if it == 'RGB' else ''}, "
                  f"fused trunk, batch {BATCH}, bf16: {stats.seconds:.3f} s for "
                  f"{stats.patches} patches = {stats.patches_per_sec:.1f} patches/s; device "
                  f"kernels {kernel_us / 1e6:.3f} s, busy share {runs[it][-1][2]:.3f} "
                  f"(torch.profiler, CUDA activity)")
        for it, r in runs.items():
            times[f"train_{it}"] = {"seconds": [v[0] for v in r],
                                    "patches_per_s": [v[1] for v in r],
                                    "busy": [v[2] for v in r]}
        del steppers, batch
        torch.cuda.empty_cache()

        # 3. snet-calibrate on the validation split, then GH evaluation at its
        # --s_cut_off (the documented workflow): K1's counts against its plain version
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cal = cli.main(["calibrate", "--data_dir", d, "--fold", "1", "--model_dir",
                            gh.ckpt_dir, "--patch_size", str(SIZE), "--batch_size", str(BATCH),
                            "--split", "valid", "--input_type", "GH", "--blankfield", "1"],
                           device=device)
        times["calibrate_s"] = time.perf_counter() - t0
        if cal["n_pixels"] != len(valid_list) * SIZE * SIZE:
            raise AssertionError(f"snet-calibrate counted {cal['n_pixels']} pixels")
        print(f"[phase 18] snet-calibrate --input_type GH --blankfield 1 --split valid: "
              f"{times['calibrate_s']:.3f} s wall, {len(valid_list)} patches; --s_cut_off "
              f"{cal['s_cut_off']:.6f} at coverage {cal['achieved_coverage']:.6f}")
        ecfg = EvalConfig(data_dir=d, test_fold=1, model_dir=gh.ckpt_dir, model_arch=["UNet_B"],
                          selective=True, select_eval=True, batch_size=BATCH, patch_size=SIZE,
                          compute_dtype="bfloat16", num_workers=INPUTS_WORKERS, input_type="GH",
                          blankfield=True, s_cut_off=cal["s_cut_off"])
        seen = []

        def record(module, args, out):
            if isinstance(module, UNetB):
                seen.append((args[0], out[0], out[1]))

        hook = torch.nn.modules.module.register_module_forward_hook(record)
        before = em.launches
        t0 = time.perf_counter()
        try:
            res = evaluate(ecfg, verbose=False, device=device)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        eval_wall = time.perf_counter() - t0
        eval_launches = em.launches - before
        k1_path = em.launches  # the kernel-vs-plain comparisons below are not the path's
        batches = list(make_eval_loader(ecfg, device))
        if eval_launches != len(batches) or len(seen) != len(batches):
            raise AssertionError(f"GH evaluate(): {eval_launches} eval_metrics launches, "
                                 f"{len(seen)} forwards for {len(batches)} batches")
        kw = dict(apply_sigmoid=True, selective=True, cut_off=ecfg.cut_off,
                  s_cut_off=ecfg.s_cut_off)
        cm = torch.zeros((2, 2), dtype=torch.int64, device=device)
        n_pix = n_reject = 0
        for (x, out, sel), b in zip(seen, batches):
            want_x, label = device_preprocess(b)
            if not torch.equal(x, want_x):
                raise AssertionError("GH evaluate() saw other inputs than the GH feed's")
            want = em.eval_metrics_reference(out, label, sel, **kw)
            got = em.fused_eval_metrics(out, label, sel, **kw)
            if not same_counts(got, want):
                raise AssertionError(f"GH eval: kernel {got} != plain version {want}")
            cm += want["cm"]
            n_pix += int(want["n_pix"])
            n_reject += int(want["n_reject"])
        if not (np.array_equal(cm.cpu().numpy(), res["confusion_matrix"].astype(np.int64))
                and n_pix == len(test_list) * SIZE * SIZE
                and res["rejection_ratio"] == n_reject / n_pix
                and math.isfinite(res["accuracy"]) and 0 < res["rejection_ratio"] < 1):
            raise AssertionError(f"GH evaluate()'s counts {res['confusion_matrix']} != the plain "
                                 f"version's {cm.cpu().numpy()}")
        print(f"[phase 18] evaluate() --input_type GH --blankfield 1 --select_eval 1 "
              f"--s_cut_off {cal['s_cut_off']:.6f}: {len(test_list)} test "
              f"patches in {len(batches)} batches, {eval_wall:.3f} s wall; eval_metrics launches "
              f"{eval_launches}, its counts == the plain version's on evaluate()'s own logits, "
              f"batch by batch, and == evaluate()'s totals (n_pix {n_pix}); accuracy "
              f"{res['accuracy']:.6f}, rejection ratio {res['rejection_ratio']:.6f}")
        times["eval_wall_s"] = eval_wall
        del seen, batches

        # 4. snet-predict and snet-wsi on the GH + blank-field checkpoint
        img = os.path.join(d, f"200x_{SIZE}", test_list[0][0])
        out_dir = os.path.join(d, "pred")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["predict", img, "--model_path", ckpt, "--selective", "1",
                      "--input_type", "GH", "--blankfield", "1", "--save_dir", out_dir,
                      "--save_prob", "1"], device=device)
        times["predict_s"] = time.perf_counter() - t0
        prob = np.load(os.path.join(out_dir, os.path.basename(img)[:-4] + "_prob.npy"))
        x = predict_tool._load_image(img, "GH", True)
        ref = load_weights(build_model("UNet_B", selective=True, in_ch=2),
                           load_net_checkpoint(ckpt)).to(device)
        with torch.inference_mode(), float32_convs(torch):
            want = torch.sigmoid(ref(normalize_raw(device_ingest(x[None], device))
                                     .permute(0, 3, 1, 2))[0])[0].cpu().numpy()
        err = float(np.abs(prob - want).max())
        print(f"[phase 18] snet-predict --input_type GH --blankfield 1 on a {SIZE}x{SIZE} patch: "
              f"{times['predict_s']:.3f} s wall; max |prob - the float32 forward| {err:.4e} "
              f"(tolerance {INPUTS_PROB_TOL})")
        if not (x.shape == (SIZE, SIZE, 2) and x.dtype == np.float32 and err <= INPUTS_PROB_TOL):
            raise AssertionError("snet-predict's GH probabilities disagree with the forward")
        del ref

        one = os.path.join(d, "one_slide")  # a test fold of one slide
        os.makedirs(one)
        os.symlink(os.path.join(d, f"200x_{SIZE}"), os.path.join(one, f"200x_{SIZE}"))
        pairs = sorted((p for p in np.concatenate([train_list, valid_list, test_list])
                        if p[0].startswith("slide00_")), key=lambda p: int(p[0].split("_")[1]))
        for i in range(1, 6):
            for cls in ("tumorable", "non_tumorable"):
                arr = np.array(pairs) if (i, cls) == (1, "tumorable") else np.empty((0, 2), "<U64")
                np.save(os.path.join(one, f"{i}-fold_{cls}_data.npy"), arr)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            results = cli.main(["wsi", "--data_dir", one, "--model_path", ckpt, "--selective", "1",
                                "--nrow", "4", "--input_type", "GH", "--blankfield", "1",
                                "--patch_size", str(SIZE), "--batch_size", "32",
                                "--num_workers", str(INPUTS_WORKERS)], device=device)
        times["wsi_s"] = time.perf_counter() - t0
        r = results.get("slide00")
        if not (len(results) == 1 and r is not None and np.isfinite(r["prob"]).all()
                and r["sample"].shape == (4 * SIZE, INPUTS_PER_SLIDE // 4 * SIZE, 2)):
            raise AssertionError(f"snet-wsi of one GH slide: {list(results)}")
        print(f"[phase 18] snet-wsi --input_type GH --blankfield 1, one slide of {len(pairs)} "
              f"patches (--nrow 4): {times['wsi_s']:.3f} s wall; WSI score "
              + " ".join(f"{v:.4f}" for v in r["wsi_score"]))

        print(f"[phase 18] on {card}: CLI walls, GH + blank-field: snet-predict "
              f"{times['predict_s']:.3f} s, snet-wsi (one slide) {times['wsi_s']:.3f} s, "
              f"snet-calibrate {times['calibrate_s']:.3f} s")

    # 5. a JAX .ckpt read here, by the port's own decoder
    has_msgpack = importlib.util.find_spec("msgpack") is not None
    if has_msgpack:
        import msgpack

        has_msgpack = f"yes, msgpack {'.'.join(map(str, msgpack.version))}"
    repo = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(repo, "tests", "data", "jax_fixture.ckpt")
    want = np.load(os.path.join(repo, "tests", "data", "jax_fixture.npz"))
    flat = _flatten_tree(load_flax_msgpack(fixture))
    if sorted(flat) != sorted(want.files) or not all(
            flat[k].dtype == want[k].dtype and np.array_equal(flat[k], want[k])
            for k in want.files):
        raise AssertionError(f"load_flax_msgpack of {fixture} disagrees with its .npz")
    print(f"[phase 18] msgpack importable here: {has_msgpack or 'no'} (not used); "
          f"tests/data/jax_fixture.ckpt (written by the JAX package's save_checkpoint) decoded "
          f"by load_flax_msgpack (the port's decoder): {len(want.files)} arrays == "
          f"jax_fixture.npz")

    times["launches_k1"], times["launches_k2"] = k1_path, k2_path
    times["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 18] eval_metrics launches {k1_path} (evaluate()), fused_conv_stats launches "
          f"{k2_path} (train()) on the input-pipeline path, each counted from 0 at the "
          f"phase's start and read right after its entry point; not counted there: "
          f"fused_conv_stats {fc.launches - k2_path} in the fused-vs-classic step and the "
          f"timed train passes, eval_metrics {em.launches - k1_path} in the comparisons with "
          f"the plain version; phase 18 took {times['seconds']:.1f} s")
    if k1_path == 0 or k2_path == 0:
        raise AssertionError("the input-pipeline path launched K1 or K2 no time")
    torch.cuda.empty_cache()
    return times


TOOLS_SEED = SEED + 19
# 6 slides x 16 hard patches of 256x256: fold 1 trains 4 batches of 16 a
# epoch, validates on 20 patches and tests on 20
TOOLS_SLIDES, TOOLS_PER_SLIDE, TOOLS_BATCH = 6, 16, 16
TOOLS_WORKERS = 8
TOOLS_ROW_TOL = 1e-2  # phase 7's: two trainings of the cell differ in their rounding
REMAT_TOL = 1e-3      # relative: the same step, the forward run once more
BF16_STATS_TOL = 1e-2  # relative: bf16 against float32 batch statistics, one step
EXPORT_BATCH = 8
FIXTURE_CKPT = os.path.join("tests", "data", "jax_fixture.ckpt")


def _csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(a, b, tol) -> float:
    """Header and text columns equal, numbers within tol; the largest gap."""
    if len(a) != len(b) or a[0] != b[0]:
        raise AssertionError(f"sweep CSVs differ in their header or length: {a[0]} vs {b[0]}")
    worst = 0.0
    for ra, rb in zip(a[1:], b[1:]):
        for va, vb in zip(ra, rb):
            try:
                fa = [float(t) for t in va.split()]
                fb = [float(t) for t in vb.split()]
            except ValueError:
                fa = fb = None
            if fa is None or not fa:
                if va != vb:
                    raise AssertionError(f"sweep CSV rows differ: {ra} vs {rb}")
                continue
            gap = max(abs(x - y) for x, y in zip(fa, fb))
            worst = max(worst, gap)
            if len(fa) != len(fb) or not gap <= tol:
                raise AssertionError(f"sweep CSV rows differ past {tol}: {ra} vs {rb}")
    return worst


def phase_tools(torch, fc, em, device, card: str) -> dict:
    """Phase 19: the tools and the single-card train variants at full width
    (UNet_B, 256x256, bf16): a hard synthetic tree and its fold lists
    (``snet-split``), ``run_sweep`` in process (K2 trains, K1 scores every
    epoch and the winner; their counters set to 0 just before it and read
    just after) and the same cell in a child process on the card,
    ``read_scalars`` on its TensorBoard logs, ``inspect_ckpt``,
    ``snet-export --check 1`` and the artifact's forward against the
    Predictor's, ``--remat`` and ``--bn_stats bfloat16`` steps at batch 128,
    ``train()`` with ``--profile_dir``, and the port's bench in a
    subprocess. Returns its times and K1's and K2's launches."""
    import dataclasses
    import subprocess

    from selectivenet_for_semantic_segmentation_binary_torch import cli
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.data.folds import (
        construct_test, construct_train_valid)
    from selectivenet_for_semantic_segmentation_binary_torch.models import (
        build_model, init_weights, load_weights)
    from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import device_ingest
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        CBR_LAYERS, median_ms_device)
    from selectivenet_for_semantic_segmentation_binary_torch.tools import (
        data_split, export, inspect_ckpt, sweep)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches, write_hard_synthetic_patch_tree)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        make_train_step, train)
    from selectivenet_for_semantic_segmentation_binary_torch.utils.tb_reader import (
        read_scalars)

    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as d:
        # 1. the hard tree, and its fold lists rebuilt by snet-split
        data = os.path.join(d, "data")
        t0 = time.perf_counter()
        write_hard_synthetic_patch_tree(data, n_slides=TOOLS_SLIDES,
                                        patches_per_slide=TOOLS_PER_SLIDE, patch_size=SIZE,
                                        seed=TOOLS_SEED)
        wrote = time.perf_counter() - t0
        counts = data_split.build_fold_lists(data, patch_size=SIZE,
                                             out_dir=os.path.join(d, "rebuilt"))
        for cls in ("tumorable", "non_tumorable"):
            lists = {}
            for where in (data, os.path.join(d, "rebuilt")):
                folds = [np.load(os.path.join(where, f"{i}-fold_{cls}_data.npy"))
                         for i in range(1, 6)]
                lists[where] = (sorted(map(tuple, np.concatenate(folds).tolist())),
                                [len(f) for f in folds])
            if lists[data] != lists[os.path.join(d, "rebuilt")]:
                raise AssertionError(f"snet-split's {cls} lists differ from the writer's")
        train_list, valid_list = construct_train_valid(data, test_fold=1, seed=SEED)
        test_list = construct_test(data, test_fold=1)
        print(f"[phase 19] data: write_hard_synthetic_patch_tree, {TOOLS_SLIDES} slides x "
              f"{TOOLS_PER_SLIDE} patches of {SIZE}x{SIZE} in {wrote:.2f} s; snet-split's "
              f"build_fold_lists: {counts}, the same pairs a class and the same fold sizes as "
              f"the writer's (the writer deals round-robin, snet-split shuffles with "
              f"KFold(seed 44)); fold 1: {len(train_list)} train, {len(valid_list)} "
              f"validation, {len(test_list)} test")

        # 2. the sweep in process: K2 trains, K1 scores
        kw = dict(folds=[1], variants=[sweep.Variant("baseline")],
                  train_overrides=dict(model_arch="UNet_B", selective=True, loss="BCElogit",
                                       s_lamb=2.0, n_epoch=2, batch_size=TOOLS_BATCH,
                                       patch_size=SIZE, compute_dtype="bfloat16",
                                       fused_cbr="on", num_workers=TOOLS_WORKERS, seed=SEED),
                  eval_overrides={"select_eval": True}, select_overrides={"select_eval": False},
                  verbose=False)
        roots = {name: os.path.join(d, name) for name in ("sweep", "isolated")}
        fc.launches = em.launches = 0
        t0 = time.perf_counter()
        rows = sweep.run_sweep(data, roots["sweep"], save_dir=os.path.join(d, "csv_sweep"),
                               device=device, **kw)
        torch.cuda.synchronize()
        times["sweep_s"] = time.perf_counter() - t0
        k1_tools, k2_tools = em.launches, fc.launches
        n_train = len(train_list) // TOOLS_BATCH
        n_valid, n_test = (-(-len(valid_list) // TOOLS_BATCH), -(-len(test_list) // TOOLS_BATCH))
        want_k2 = len(CBR_LAYERS) * (n_train + n_valid) * 2
        want_k1 = 2 * n_valid + n_test
        row = rows[0]
        print(f"[phase 19] run_sweep (1 variant x 1 fold x 2 epochs, batch {TOOLS_BATCH}, "
              f"--fused_cbr on, in process): {times['sweep_s']:.3f} s wall; best epoch "
              f"{row['best_epoch']}, valid mIoU {row['valid_mIoU']:.6f}, test mIoU "
              f"{row['mIoU']:.6f}, rejection ratio {row['rejection_ratio']:.6f}; "
              f"fused_conv_stats launches {k2_tools} (want 13 x {n_train + n_valid} x 2 = "
              f"{want_k2}), eval_metrics launches {k1_tools} (want 2 x {n_valid} + {n_test} = "
              f"{want_k1})")
        if (k2_tools, k1_tools) != (want_k2, want_k1):
            raise AssertionError("the sweep did not launch K1 and K2 as its batches say")
        if not all(math.isfinite(row[k]) for k in ("accuracy", "mIoU", "rejection_ratio")):
            raise AssertionError(f"the sweep's row is not finite: {row}")

        # the same cell once more, in a child process on the card
        t0 = time.perf_counter()
        iso = sweep.run_sweep(data, roots["isolated"], save_dir=os.path.join(d, "csv_iso"),
                              device=device, isolate_cells=True, cell_retries=0, **kw)
        times["isolated_s"] = time.perf_counter() - t0
        if iso[0]["best_epoch"] != row["best_epoch"]:
            raise AssertionError(f"the child picked epoch {iso[0]['best_epoch']}, "
                                 f"the parent {row['best_epoch']}")
        gap = _same_csv(_csv_rows(os.path.join(d, "csv_sweep", "sweep_summary.csv")),
                        _csv_rows(os.path.join(d, "csv_iso", "sweep_summary.csv")),
                        TOOLS_ROW_TOL)
        print(f"[phase 19] run_sweep(isolate_cells=True), the cell in a child process on "
              f"{device}: {times['isolated_s']:.3f} s wall; the two sweep_summary.csv equal in "
              f"header, text columns and best epoch, numbers within {gap:.3e} (tolerance "
              f"{TOOLS_ROW_TOL})")

        # 3. the TensorBoard scalars, read back
        log = os.path.join(roots["sweep"], "baseline", "1-fold", "log")
        scalars = {split: read_scalars(os.path.join(log, split)) for split in ("train", "valid")}
        losses = {split: scalars[split]["loss"] for split in scalars}
        if any([s for s, _ in v] != [1, 2] or not all(map(math.isfinite, (x for _, x in v)))
               for v in losses.values()):
            raise AssertionError(f"read_scalars found {losses}")
        print(f"[phase 19] read_scalars on the cell's logs: train loss {losses['train']}, "
              f"valid loss {losses['valid']}; tags {sorted(scalars['train'])}")

        # 4. inspect_ckpt: the two cells' checkpoints, and the JAX fixture
        ckpt_dir = os.path.join(roots["sweep"], "baseline", "1-fold", "checkpoint")
        best = os.path.join(ckpt_dir, f"model_epoch{row['best_epoch']}.pth")
        other = os.path.join(roots["isolated"], "baseline", "1-fold", "checkpoint",
                             os.path.basename(best))
        diff = inspect_ckpt.compare(best, other)
        if diff["only_in_a"] or diff["only_in_b"] or diff["shape_mismatch"]:
            raise AssertionError(f"inspect_ckpt.compare of the two cells' files: {diff}")
        info = inspect_ckpt.summarize(best)
        print(f"[phase 19] inspect_ckpt: {os.path.basename(best)} {info['n_tensors']} tensors, "
              f"{info['n_params']:,} parameters, payload {info['payload_keys']}; compare with "
              f"the child's file: MATCH ({diff['n_shared']} shared)")
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), FIXTURE_CKPT)
        fx = inspect_ckpt.summarize(fixture)
        try:
            inspect_ckpt.compare(best, fixture)
        except KeyError as e:
            if any(k.startswith("params/trunk/") for k in fx["tensors"]):
                raise
            print(f"[phase 19] inspect_ckpt.compare with {FIXTURE_CKPT}: no MATCH to report, "
                  f"the keys differ because the fixture's net is no UNet: "
                  f"{sorted(fx['tensors'])} ({fx['n_params']} parameters), no {e} scope to "
                  f"map to the reference names (the JAX tool refuses it alike)")
        else:
            raise AssertionError("inspect_ckpt.compare mapped the one-layer fixture")

        # 5. snet-export --check 1 of the winner, and the artifact's forward
        art = os.path.join(d, "serve.pt2")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            meta = cli.main(["export", "--out", art, "--model_path", best, "--selective", "1",
                             "--batch", str(EXPORT_BATCH), "--height", str(SIZE), "--width",
                             str(SIZE), "--check", "1"], device=device)
        times["export_s"] = time.perf_counter() - t0
        checked = [ln for ln in buf.getvalue().splitlines() if ln.startswith("check ok")]
        if not checked or meta["platforms"] != [torch.device(device).type]:
            raise AssertionError(f"snet-export --check 1: {buf.getvalue()}")
        print(f"[phase 19] snet-export --check 1 at ({EXPORT_BATCH}, {SIZE}, {SIZE}, 3), bf16 "
              f"folded: {times['export_s']:.3f} s wall, {meta['size_bytes'] / 1e6:.1f} MB; "
              f"{checked[0]}")
        art128 = os.path.join(d, "serve128.pt2")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["export", "--out", art128, "--model_path", best, "--selective", "1",
                      "--batch", str(BATCH), "--height", str(SIZE), "--width", str(SIZE),
                      "--check", "0"], device=device)
        module = export.load_exported(art128).module()
        predictor = Predictor(best, selective=True, device=device)
        images = InMemoryPatches(BATCH, SIZE, TOOLS_SEED).inputs
        xu8 = device_ingest(images, device)
        xf = torch.from_numpy(images.astype(np.float32) / 255.0).to(device)
        with torch.inference_mode():
            got = module(xf)
            want = predictor.predict(images)
            err = float((got["prob"].cpu() - torch.from_numpy(want["prob"])).abs().max())
            a1 = median_ms_device(lambda: module(xf))
            p1 = median_ms_device(lambda: predictor._forward(xu8))
            p2 = median_ms_device(lambda: predictor._forward(xu8))
            a2 = median_ms_device(lambda: module(xf))
        times["artifact_ms"], times["predictor_ms"] = (a1 + a2) / 2, (p1 + p2) / 2
        print(f"[phase 19] on {card}: the exported artifact at batch {BATCH} (float32 [0,1] "
              f"in, probabilities out) {times['artifact_ms']:.3f} ms ({a1:.3f}/{a2:.3f}) vs the "
              f"Predictor's folded forward (uint8 in, logits out) {times['predictor_ms']:.3f} "
              f"ms ({p1:.3f}/{p2:.3f}), device medians of 20 in turns; max |prob - "
              f"Predictor.predict| {err:.3e} (tolerance {export.CHECK_TOL['bfloat16']})")
        if not err <= export.CHECK_TOL["bfloat16"]:
            raise AssertionError("the batch-128 artifact disagrees with the Predictor")
        del module, predictor, xu8, xf, got
        torch.cuda.empty_cache()

        # 6. --remat and --bn_stats bfloat16: one step at batch 128 from the
        # same weights and batch against the plain step
        state = {k: v.detach().clone() for k, v in
                 load_weights(build_model("UNet_B", selective=True),
                              torch.load(best, weights_only=True)["net"]).state_dict().items()}
        patches = InMemoryPatches(BATCH, SIZE, TOOLS_SEED + 1)
        flips = np.random.default_rng(TOOLS_SEED).integers(0, 2, (BATCH, 2)).astype(np.uint8)
        batch = {"input": torch.from_numpy(patches.inputs).to(device),
                 "label": torch.from_numpy(patches.labels).to(device),
                 "flips": torch.from_numpy(flips).to(device)}
        base_cfg = TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit",
                               s_lamb=2.0, batch_size=BATCH, patch_size=SIZE,
                               compute_dtype="bfloat16", seed=SEED)

        def one_step(fused, **flags):
            cfg = dataclasses.replace(base_cfg, **flags)
            model = build_model("UNet_B", selective=True, compute_dtype="bfloat16",
                                fused=fused, bn_stats=cfg.bn_stats)
            load_weights(model, state)
            model.to(device)
            step = make_train_step(model, cfg, build_optimizer(cfg, model.parameters()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            l0, r0 = fc.launches, fc.launches_recompute
            loss = float(step(batch, cfg.lr)["loss"])
            launches = (fc.launches - l0, fc.launches_recompute - r0)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            stats = torch.cat([b.flatten() for k, b in model.state_dict().items()
                               if k.endswith(("running_mean", "running_var"))]).float()
            grads = [p.grad.detach().float().clone() for p in model.parameters()]
            # the second step's loss reads the parameters the first step updated
            loss2 = float(step(batch, cfg.lr)["loss"])
            ms = median_ms(lambda: step(batch, cfg.lr), runs=5, warmup=1)
            del model, step
            torch.cuda.empty_cache()
            return {"loss": loss, "stats": stats, "grads": grads, "loss2": loss2,
                    "peak_gib": peak, "ms": ms, "launches": launches}

        steps = {}
        for fused in (False, True):
            name = "fused" if fused else "classic"
            plain, remat = one_step(fused), one_step(fused, remat=True)
            rel_loss = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
            rel_stats = float((remat["stats"] - plain["stats"]).abs().max()
                              / plain["stats"].abs().max())
            # each parameter's gradient, norm-wise against the plain step's
            rel_grad = max(float((a - b).norm() / b.norm())
                           for a, b in zip(remat.pop("grads"), plain.pop("grads"))
                           if float(b.norm()) > 0)
            rel_loss2 = abs(remat["loss2"] - plain["loss2"]) / abs(plain["loss2"])
            steps[name] = {"plain": plain, "remat": remat}
            print(f"[phase 19] on {card}: --remat, one {name} step at batch {BATCH}, "
                  f"{SIZE}x{SIZE}, bf16, from the same weights and batch: loss {remat['loss']:.6f} "
                  f"vs {plain['loss']:.6f} (rel. {rel_loss:.3e}), BN running stats rel. "
                  f"{rel_stats:.3e}, gradients rel. (worst parameter, norm-wise) "
                  f"{rel_grad:.3e}, the second step's loss from the updated parameters "
                  f"{remat['loss2']:.6f} vs {plain['loss2']:.6f} (rel. {rel_loss2:.3e}) "
                  f"(tolerance {REMAT_TOL}); peak memory {remat['peak_gib']:.2f} "
                  f"GiB vs {plain['peak_gib']:.2f} GiB; step {remat['ms']:.3f} ms vs "
                  f"{plain['ms']:.3f} ms (host medians of 5)"
                  + (f"; fused_conv_stats launches in the remat step {remat['launches'][0]}, "
                     f"{remat['launches'][1]} of them in the recompute (plain step "
                     f"{plain['launches'][0]})" if fused else ""))
            if not (rel_loss <= REMAT_TOL and rel_stats <= REMAT_TOL and rel_grad <= REMAT_TOL
                    and rel_loss2 <= REMAT_TOL):
                raise AssertionError(f"the {name} remat step disagrees with the plain one")
            if fused and (remat["launches"] != (26, 13) or plain["launches"] != (13, 0)):
                raise AssertionError(f"fused remat launches {remat['launches']}, plain "
                                     f"{plain['launches']}")
        bf = one_step(False, bn_stats="bfloat16")
        f32 = steps["classic"]["plain"]
        rel = abs(bf["loss"] - f32["loss"]) / abs(f32["loss"])
        print(f"[phase 19] on {card}: --bn_stats bfloat16, one classic step at batch {BATCH}: "
              f"loss {bf['loss']:.6f} vs float32 statistics {f32['loss']:.6f} (rel. {rel:.3e}, "
              f"tolerance {BF16_STATS_TOL}); step {bf['ms']:.3f} ms vs {f32['ms']:.3f} ms, peak "
              f"{bf['peak_gib']:.2f} GiB vs {f32['peak_gib']:.2f} GiB")
        if not rel <= BF16_STATS_TOL:
            raise AssertionError("the bf16-statistics step is too far from the float32 one")
        try:
            build_model("UNet_B", selective=True, compute_dtype="bfloat16", fused=True,
                        bn_stats="bfloat16")
        except ValueError as e:
            if "bn_stats" not in str(e):
                raise
            print(f"[phase 19] the fused trunk with --bn_stats bfloat16 raises: {e}")
        else:
            raise AssertionError("the fused trunk took --bn_stats bfloat16")
        for name, pair in steps.items():
            for kind in ("plain", "remat"):
                times[f"{name}_{kind}_ms"] = pair[kind]["ms"]
                times[f"{name}_{kind}_peak_gib"] = pair[kind]["peak_gib"]
        times["bf16_stats_ms"], times["bf16_stats_peak_gib"] = bf["ms"], bf["peak_gib"]
        del batch, state

        # 7. train() with --profile_dir: the second epoch's trace names the kernel
        prof = os.path.join(d, "prof")
        cfg = TrainConfig(data_dir=data, model_dir=os.path.join(d, "profiled"), fold=1,
                          model_arch="UNet_B", selective=True, loss="BCElogit",
                          batch_size=TOOLS_BATCH, patch_size=SIZE, n_epoch=2,
                          compute_dtype="bfloat16", fused_cbr="on", num_workers=TOOLS_WORKERS,
                          seed=SEED, profile_dir=prof)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train(cfg, device=device)
        times["profiled_train_s"] = time.perf_counter() - t0
        trace = os.path.join(prof, "epoch2.pt.trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if "fused_conv_stats" in e.get("name", "")
                   and e.get("cat") == "kernel"]
        print(f"[phase 19] train() --profile_dir, 2 epochs: {times['profiled_train_s']:.3f} s "
              f"wall; {os.path.basename(trace)} {os.path.getsize(trace) / 1e6:.1f} MB, "
              f"{len(events)} events, {len(kernels)} kernel events named fused_conv_stats")
        if not kernels:
            raise AssertionError("the profiled epoch's trace names no fused_conv_stats kernel")

    # 8. the port's bench, as a user runs it
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m",
                          "selectivenet_for_semantic_segmentation_binary_torch.bench"],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    times["bench_s"] = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"the port's bench failed: {run.stderr[-2000:]}")
    line = run.stdout.strip().splitlines()[-1]
    bench = json.loads(line)
    if "ceiling_x" in bench or not (bench["value"] > 0 and bench["eval_value"] > 0):
        raise AssertionError(f"the port's bench printed {line}")
    print(f"[phase 19] on {card}: python -m selectivenet_for_semantic_segmentation_binary_torch"
          f".bench ({times['bench_s']:.1f} s wall):")
    print(line)
    times["bench"] = bench
    times["launches_k1"], times["launches_k2"] = k1_tools, k2_tools
    times["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 19] eval_metrics launches {k1_tools}, fused_conv_stats launches {k2_tools} "
          f"on the tools path (run_sweep in process, counters set to 0 just before it and "
          f"read just after); phase 19 took {times['seconds']:.1f} s")
    if k1_tools == 0 or k2_tools == 0:
        raise AssertionError("the tools path launched K1 or K2 no time")
    torch.cuda.empty_cache()
    return times


# phase 20: the int8 path. K10 must equal its plain version bit for bit (the
# int32 sums are exact and the epilogue's order is fixed). The int8 Predictor
# is held to the bf16 folded Predictor with the bounds of the JAX package's
# tests/test_quant.py::test_tracks_float_predictor (max |prob difference|,
# share of equal masks), and int8 eval's accuracy to bf16 eval's with
# test_eval_quantize_tracks_bf16's, on the model those tests build (torch's
# default init, which the JAX package mirrors); on phase 16's seeded model
# the distances are printed, not held (see the print). The QAT step's loss
# must differ from the float step's, within tests/test_torch_qat.py's
# QAT_LOSS_REL of it, and its gradients point the float way
# (tests/test_qat.py's cosine bound).
INT8_SEED = SEED + 20
INT8_PROB_TOL, INT8_MASK_AGREE = 0.01, 0.99
INT8_ACC_TOL = 0.02
QAT_LOSS_REL, QAT_GRAD_COS = 5e-2, 0.8
INT8_SLIDES, INT8_CALIB_IMAGES = 5, 2
PLAIN_RUNS = 3  # the float64 plain version is slow: its median of 3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_int8(torch, ic, em, device, card: str, against=None) -> dict:
    """Phase 20: the int8 path at full width. Returns K10's record with its
    launches on the path, and K1's launches in the int8 eval; with
    ``against`` (another commit's kernels/), K10 against its build there."""
    import signal
    import subprocess

    from PIL import Image

    from selectivenet_for_semantic_segmentation_binary_torch import cli, models
    from selectivenet_for_semantic_segmentation_binary_torch.config import TrainConfig
    from selectivenet_for_semantic_segmentation_binary_torch.models import unet
    from selectivenet_for_semantic_segmentation_binary_torch.ops.ingest import device_ingest
    from selectivenet_for_semantic_segmentation_binary_torch.optim import build_optimizer
    from selectivenet_for_semantic_segmentation_binary_torch.predictor import Predictor
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.int8_conv_against import (
        layer_bytes as k10_bytes, operands as k10_operands)
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import (
        INT8_LAYERS, PEAK_INT8_OPS, bound_ms, median_ms_device, summed_bounds)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.profile_eval_step import (
        median_ms)
    from selectivenet_for_semantic_segmentation_binary_torch.tools.synthetic import (
        InMemoryPatches, seeded_model)
    from selectivenet_for_semantic_segmentation_binary_torch.train_lib import (
        _losses, _targets, device_preprocess, make_train_step)

    t_phase = time.perf_counter()
    out = {}
    g = torch.Generator(device=device).manual_seed(INT8_SEED)

    # 1. K10 against its plain version: every trunk shape at batch 128, both
    # epilogues, bf16 and float32 inputs; the first layer at Cin 2 and 3
    cases = [(ci, co, sz, xd, dyn) for _, ci, co, sz in INT8_LAYERS
             for xd in (torch.bfloat16, torch.float32) for dyn in (False, True)]
    cases += [(2, 64, SIZE, torch.float32, False), (2, 64, SIZE, torch.bfloat16, True)]
    t0 = time.perf_counter()
    for cin, cout, sz, xd, dyn in cases:
        x, wq, a, ks, bias = k10_operands(g, device, BATCH, sz, cin, cout, xd)
        od = torch.float32 if dyn or xd == torch.float32 else torch.bfloat16
        b = None if dyn else bias
        got = ic.int8_conv(x, wq, a, ks, b, od, dyn)
        want = ic.int8_conv_reference(x, wq, a, ks, b, od, dyn)
        if got.dtype != want.dtype or not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"K10 {BATCH}x{sz}x{sz}x{cin}->{cout} {xd} dynamic={dyn}: "
                                 f"differs from the plain version (max |diff| {err:.3e})")
        del x, wq, got, want
    torch.cuda.synchronize()
    print(f"[phase 20] int8_conv == plain version bit for bit in {len(cases)} cases: the 14 "
          f"trunk shapes of UNet_B at batch {BATCH} (H = W from {SIZE} down to 32), static "
          f"and dynamic epilogues, bf16 and float32 inputs, Cin 2 and 3 on the first "
          f"layer's im2col kernel ({time.perf_counter() - t0:.1f} s)")
    paths = {name: ic.kernel_path(BATCH, sz, sz, ci, co, torch.bfloat16)
             for name, ci, co, sz in INT8_LAYERS}
    lib_paths = {name: ic._kernel().int8_conv_path(BATCH, sz, sz, ci, co, 1)
                 for name, ci, co, sz in INT8_LAYERS}
    print(f"[phase 20] kernel_path at batch {BATCH}, bf16 x: {paths}")
    wide = [name for name, ci, _, _ in INT8_LAYERS if ci >= 64]
    names = {0: "mma_sync", 1: "wgmma", 2: "wgmma_im2col"}
    if (len(wide) != 13 or any(paths[name] != "wgmma" for name in wide)
            or paths["enc1_1"] != "wgmma_im2col"
            or any(names[lib_paths[k]] != v for k, v in paths.items())):
        raise AssertionError("the 13 layers with Cin >= 64 do not all take the wgmma kernel "
                             "and the first the im2col kernel, or kernel_path and the "
                             "source's int8_conv_path disagree")
    torch.cuda.empty_cache()

    # two checkpoints: the JAX tests' model (torch's default init, which the
    # JAX package mirrors: logits near 0) and phase 16's seeded model with BN
    # statistics away from the identity (logits of a few units)
    states = {"init": models.init_weights(models.build_model("UNet_B", selective=True),
                                          torch.Generator().manual_seed(INT8_SEED))
              .state_dict(),
              "seeded": serving_state(torch, INT8_SEED)}
    images = InMemoryPatches(BATCH, SIZE, INT8_SEED).inputs
    calib_images = InMemoryPatches(INT8_CALIB_IMAGES, SIZE, INT8_SEED + 1).inputs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as d:
        paths = {}
        for name, st in states.items():
            paths[name] = os.path.join(d, f"{name}.pth")
            torch.save({"net": st}, paths[name])
        path = paths["seeded"]
        calib_png, image_png = os.path.join(d, "calib.png"), os.path.join(d, "image.png")
        Image.fromarray(calib_images[0]).save(calib_png)
        Image.fromarray(images[0]).save(image_png)

        # the main path, counted from here to the QAT step
        ic.launches = 0

        # 2. the int8 Predictor at batch 128, calibrated on the batch: K10
        # against the plain version swapped in, then against the bf16 folded
        # Predictor (held to the JAX bounds on the JAX tests' model)
        for name in ("init", "seeded"):
            t0 = time.perf_counter()
            pq = Predictor(paths[name], selective=True, quantize="int8",
                           calibration_images=images, device=device)
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t0
            before = ic.launches
            got = pq.predict(images)
            if ic.launches - before != 14:
                raise AssertionError(f"an int8 forward launched K10 {ic.launches - before} "
                                     f"times, not 14")
            launched = ic.launches
            saved = unet.int8_conv
            unet.int8_conv = ic.int8_conv_reference
            try:
                plain = pq.predict(images)
            finally:
                unet.int8_conv = saved
            if ic.launches != launched:
                raise AssertionError("the plain version's forward launched K10")
            for k in got:
                if not np.array_equal(got[k], plain[k]):
                    raise AssertionError(f"the int8 Predictor's {k} through K10 differs from "
                                         f"the plain version's")
            pf = Predictor(paths[name], selective=True, device=device)
            ref = pf.predict(images)
            dprob = float(np.abs(ref["prob"] - got["prob"]).max())
            agree = float((ref["pred"] == got["pred"]).mean())
            dsel = float(np.abs(ref["selection_prob"] - got["selection_prob"]).max())
            held = name == "init"
            print(f"[phase 20] Predictor(quantize='int8'), {name} model, batch {BATCH}, "
                  f"{SIZE}x{SIZE}, calibrated on the batch ({calib_s:.2f} s wall, chunks of 8): "
                  f"14 K10 launches a forward; prob, pred, selection_prob and selection equal "
                  f"to the plain version's swapped in on the card; against the bf16 folded "
                  f"Predictor: max |prob diff| {dprob:.4e}, masks equal {agree:.6f}, max "
                  f"|selection_prob diff| {dsel:.4e}; max |logit| of the bf16 forward "
                  f"{float(pf.logits(images[:8])[0].abs().max()):.3f}; "
                  + (f"held to the JAX bounds < {INT8_PROB_TOL}, > {INT8_MASK_AGREE}" if held
                     else "reported, not held: the JAX package's int8 trunk misses those "
                          "bounds by as much on such weights (tests/test_torch_quant.py::"
                          "test_int8_trunk_matches_jax_on_the_same_tree)"))
            if held and not (dprob < INT8_PROB_TOL and agree > INT8_MASK_AGREE):
                raise AssertionError("the int8 Predictor does not track the bf16 one")
        out["calibrate_s"] = calib_s

        # 3. snet-predict --quantize int8 --calib_images on one image
        pred_dir = os.path.join(d, "pred")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            cli.main(["predict", image_png, "--model_path", path, "--selective", "1",
                      "--quantize", "int8", "--calib_images", calib_png, "--save_dir",
                      pred_dir, "--save_prob", "1"])
        prob = np.load(os.path.join(pred_dir, "image_prob.npy"))
        direct = Predictor(path, selective=True, quantize="int8",
                           calibration_images=[calib_images[0]], device=device)
        dcli = float(np.abs(prob - direct.predict(images[:1])["prob"][0]).max())
        print(f"[phase 20] snet-predict --quantize int8 --calib_images: "
              f"{buf.getvalue().strip().splitlines()[0]!r}; prob {prob.shape}, finite, within "
              f"{dcli:.3e} of the Predictor calibrated on the same image")
        if prob.shape != (SIZE, SIZE) or not np.isfinite(prob).all() or dcli > 1e-6:
            raise AssertionError("snet-predict --quantize int8 gave another map")

        # 4. snet-wsi --quantize int8 on a tree of phase 17's writer whose
        # test fold is one slide
        tree = os.path.join(d, "tree")
        _write_analysis_tree(tree, INT8_SLIDES, 1)
        wsi = {}
        for q in ("none", "int8"):
            with contextlib.redirect_stdout(io.StringIO()):
                wsi[q] = cli.main(["wsi", "--data_dir", tree, "--model_path", path,
                                   "--selective", "1", "--nrow", str(ANALYSIS_NROW),
                                   "--patch_size", str(SIZE), "--quantize", q,
                                   "--calib_patches", "8", "--num_workers", "8"])
        (slide, rq), = wsi["int8"].items()
        dwsi = float(np.abs(rq["prob"] - wsi["none"][slide]["prob"]).max())
        print(f"[phase 20] snet-wsi --quantize int8 --calib_patches 8, seeded model, slide "
              f"{slide} {rq['prob'].shape}: finite {bool(np.isfinite(rq['prob']).all())}, WSI "
              f"score {np.round(rq['wsi_score'], 4).tolist()}; max |prob diff| vs the bf16 "
              f"snet-wsi {dwsi:.4e}")
        if not np.isfinite(rq["prob"]).all():
            raise AssertionError("snet-wsi --quantize int8 gave non-finite maps")

        # 5. snet-eval --quantize int8 (K1 on the metrics), both models: every
        # pixel of the JAX tests' model (whose selection head rejects them
        # all), in-coverage on the seeded one
        for name, st in states.items():
            select = "0" if name == "init" else "1"
            model_dir = os.path.join(d, f"models_{name}")
            os.makedirs(model_dir)
            torch.save({"net": st}, os.path.join(model_dir, "model_epoch1.pth"))
            res = {}
            for q in ("none", "int8"):
                save = os.path.join(d, f"eval_{name}_{q}")
                em.launches = 0
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    cli.main(["eval", "--data_dir", tree, "--test_fold", "1", "--model_dir",
                              model_dir, "--selective", "1", "--select_eval", select,
                              "--batch_size", str(BATCH), "--patch_size", str(SIZE),
                              "--num_workers", "8", "--quantize", q, "--calib_patches", "8",
                              "--save_dir", save])
                out[f"k1_launches_{q}"] = em.launches
                header, row = _csv_rows(os.path.join(save, "eval_fold1.csv"))
                res[q] = dict(zip(header, row))
            calib_line = next(ln.strip() for ln in buf.getvalue().splitlines()
                              if "int8 serving trunk" in ln)
            acc = {q: float(r["accuracy"]) for q, r in res.items()}
            dacc = abs(acc["int8"] - acc["none"])
            held = name == "init"
            print(f"[phase 20] snet-eval --quantize int8 --select_eval {select} of the slide, "
                  f"{name} model: {calib_line!r}; accuracy {acc['int8']:.6f} against bf16 "
                  f"{acc['none']:.6f} (|diff| {dacc:.2e}"
                  + (f", bound {INT8_ACC_TOL}" if held else ", reported") + "), rejection "
                  f"ratio {res['int8']['rejection_ratio'] or '-'} / "
                  f"{res['none']['rejection_ratio'] or '-'}; K1 launches "
                  f"{out['k1_launches_int8']}")
            if (held and dacc >= INT8_ACC_TOL) or out["k1_launches_int8"] < 1:
                raise AssertionError("int8 eval does not track bf16 eval, or K1 did not launch")

        # 7. a classic train step with --train_quant int8 against the float
        # one, from the same weights and batch: held on the JAX tests' model
        # (test_qat.py's bounds), reported on the seeded one
        rng = np.random.default_rng(INT8_SEED)
        batch = {"input": torch.from_numpy(images).to(device),
                 "label": torch.from_numpy((rng.random((BATCH, SIZE, SIZE)) > 0.7)
                                           .astype(np.uint8)).to(device)}
        cfgs = {q: TrainConfig(model_arch="UNet_B", selective=True, loss="BCElogit",
                               s_lamb=2.0, batch_size=BATCH, patch_size=SIZE,
                               compute_dtype="bfloat16", train_quant=q)
                for q in ("none", "int8")}
        x, label = device_preprocess(batch)
        for name, base in (("init", states["init"]),
                           ("seeded", seeded_model(INT8_SEED, "float32").state_dict())):
            nets, losses, grads = {}, {}, {}
            for q, cfg in cfgs.items():
                nets[q] = models.build_model("UNet_B", 2, True, "bfloat16", train_quant=q)
                models.load_weights(nets[q], base).to(device).train()
                before = ic.launches
                loss = _losses(cfg, nets[q](x), _targets(cfg, label))[0]
                if q == "int8" and ic.launches - before != 14:
                    raise AssertionError(f"a QAT forward launched K10 {ic.launches - before} "
                                         f"times, not 14")
                loss.backward()
                losses[q] = float(loss.detach())
                grads[q] = torch.cat([p.grad.float().flatten() for p in nets[q].parameters()])
            cos = float(torch.dot(grads["none"], grads["int8"])
                        / (grads["none"].norm() * grads["int8"].norm()))
            rel = abs(losses["int8"] - losses["none"]) / abs(losses["none"])
            held = name == "init"
            print(f"[phase 20] one train step from the same weights and batch ({BATCH}x{SIZE}x"
                  f"{SIZE}, bf16, classic trunk), {name} model: loss --train_quant int8 "
                  f"{losses['int8']:.6f} vs float {losses['none']:.6f} (rel. {rel:.3e}), "
                  f"gradients' cosine {cos:.4f}; "
                  + (f"held to rel. in (0, {QAT_LOSS_REL}) and cosine > {QAT_GRAD_COS}" if held
                     else "reported, rel. > 0 held"))
            if not (np.isfinite(losses["int8"]) and rel > 0):
                raise AssertionError("the QAT loss is not a quantized step's")
            if held and not (rel < QAT_LOSS_REL and cos > QAT_GRAD_COS):
                raise AssertionError("the QAT step does not track the float step")
            del grads
        steps = {q: make_train_step(nets[q], cfgs[q],
                                    build_optimizer(cfgs[q], nets[q].parameters()))
                 for q in cfgs}
        before = ic.launches
        step_loss = float(steps["int8"](batch, 1e-3)["loss"])
        step_launches = ic.launches - before
        print(f"[phase 20] make_train_step's --train_quant int8 step: loss {step_loss:.6f}, "
              f"{step_launches} K10 launches")
        if not (np.isfinite(step_loss) and step_launches == 14):
            raise AssertionError("the QAT train step did not run K10 on its 14 layers")
        out["launches"] = ic.launches

        # 6. snet-serve --quantize int8: two HTTP requests to the CLI's server
        # (its own process: its K10 launches are not in the count above)
        port = _free_port()
        srv = subprocess.Popen(
            [sys.executable, "-m", "selectivenet_for_semantic_segmentation_binary_torch.cli",
             "serve", "--model_path", path, "--selective", "1", "--quantize", "int8",
             "--calib_images", calib_png, "--port", str(port), "--warmup", str(SIZE),
             str(SIZE), "--max_batch", "2"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = []
        try:
            for line in srv.stdout:
                lines.append(line.rstrip())
                if line.startswith("serving "):
                    break
            else:
                raise AssertionError("snet-serve --quantize int8 exited: " + "\n".join(lines))
            url = f"http://127.0.0.1:{port}"
            health = json.loads(_http(url + "/healthz")[1])
            want = direct.predict(images[:2])
            fractions = []
            for i in range(2):
                body = io.BytesIO()
                Image.fromarray(images[i]).save(body, format="PNG")
                answer = json.loads(_http(url + "/predict", body.getvalue())[1])
                fractions.append((answer["tumor_fraction"], float(want["pred"][i].mean())))
        finally:
            srv.send_signal(signal.SIGTERM)
            try:
                tail, _ = srv.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                srv.kill()
                tail, _ = srv.communicate()
        lines += tail.splitlines()
        calib_line = next((ln for ln in lines if "int8 serving trunk" in ln), None)
        print(f"[phase 20] snet-serve --quantize int8 --calib_images: {calib_line!r}; /healthz "
              f"{health}; 2 POSTed PNGs: tumor_fraction (served, the Predictor's) "
              f"{fractions}; exit {srv.returncode}, {lines[-1]!r}")
        if (health.get("quantize") != "int8" or calib_line is None or srv.returncode != 0
                or any(abs(a - b) > 1e-3 for a, b in fractions)):
            raise AssertionError("snet-serve --quantize int8 did not serve the int8 trunk")

        # 8. times: the folded forwards, predict_compact, the train steps
        x = device_ingest(images, device)
        with torch.inference_mode():
            b1 = median_ms_device(lambda: pf._forward(x))
            q1 = median_ms_device(lambda: pq._forward(x))
            q2 = median_ms_device(lambda: pq._forward(x))
            b2 = median_ms_device(lambda: pf._forward(x))
        out["int8_fwd_ms"], out["bf16_fwd_ms"] = (q1 + q2) / 2, (b1 + b2) / 2
        out["compact_ms"] = median_ms(lambda: pq.predict_compact(images), runs=10)
        print(f"[phase 20] on {card}: folded forward at batch {BATCH} (device medians of 20, "
              f"in turns): int8 {out['int8_fwd_ms']:.3f} ms ({q1:.3f}/{q2:.3f}), bf16 "
              f"{out['bf16_fwd_ms']:.3f} ms ({b1:.3f}/{b2:.3f}); int8 predict_compact "
              f"{out['compact_ms']:.3f} ms a batch (host median of 10); calibration on "
              f"{BATCH} images {out['calibrate_s']:.3f} s wall")
        step_ms = {"none": [], "int8": []}
        for q in ("none", "int8", "int8", "none"):
            step_ms[q].append(median_ms(lambda: steps[q](batch, 1e-3), runs=5, warmup=1))
        out["qat_step_ms"] = statistics.mean(step_ms["int8"])
        out["classic_step_ms"] = statistics.mean(step_ms["none"])
        print(f"[phase 20] on {card}: train step at batch {BATCH} (host medians of 5, in "
              f"turns): --train_quant int8 {out['qat_step_ms']:.3f} ms {step_ms['int8']}, "
              f"classic {out['classic_step_ms']:.3f} ms {step_ms['none']}; "
              f"{out['qat_step_ms'] / out['classic_step_ms']:.3f}x")
        del steps, nets, pq, pf, direct, x
    torch.cuda.empty_cache()

    # K10 over the 14 layers: kernel, plain version, cuDNN's bf16 conv of the
    # same layer, and torch._int_mm on one layer's im2col matrix
    ms = plain = cudnn = 0.0
    bounds = []
    print(f"[phase 20] on {card}: int8_conv layer by layer at batch {BATCH} (float32 x at the "
          f"first layer, bf16 elsewhere; the static epilogue into bf16; device medians of 20)")
    for name, cin, cout, sz in INT8_LAYERS:
        xd = torch.float32 if cin == 3 else torch.bfloat16
        x, wq, a, ks, bias = k10_operands(g, device, BATCH, sz, cin, cout, xd)
        k_ms = median_ms_device(lambda: ic.int8_conv(x, wq, a, ks, bias, torch.bfloat16))
        plain += median_ms_device(
            lambda: ic.int8_conv_reference(x, wq, a, ks, bias, torch.bfloat16),
            runs=PLAIN_RUNS, warmup=1)
        xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wc = wq.to(torch.bfloat16).permute(0, 3, 1, 2)
        c_ms = median_ms_device(lambda: torch.nn.functional.conv2d(xc, wc, padding=1))
        ms, cudnn = ms + k_ms, cudnn + c_ms
        layer_ops = 2 * BATCH * sz * sz * 9 * cin * cout
        bounds.append(bound_ms(k10_bytes(BATCH, sz, cin, cout, x.element_size(), 2),
                               layer_ops, PEAK_INT8_OPS))
        path = ic.kernel_path(BATCH, sz, sz, cin, cout, xd)
        print(f"[phase 20]   {name} {cin}->{cout} at {sz}x{sz} [{path}]: K10 {k_ms:.3f} ms "
              f"({layer_ops / k_ms / 1e9:.1f} TOP/s), bound "
              f"{bounds[-1]['bound_ms']:.3f} ms ({bounds[-1]['bound_by']}), cuDNN's bf16 conv "
              f"alone {c_ms:.3f} ms")
        del x, xc, wq, wc
    bound = summed_bounds(bounds)
    # the product alone of enc3_2 (256 -> 256 at 64x64): its im2col matrix
    # (M, 9 Cin) int8 times (9 Cin, Cout) int8
    m = BATCH * 64 * 64
    amat = torch.randint(-127, 128, (m, 9 * 256), device=device, generator=g, dtype=torch.int8)
    bmat = torch.randint(-127, 128, (9 * 256, 256), device=device, generator=g,
                         dtype=torch.int8)
    int_mm = median_ms_device(lambda: torch._int_mm(amat, bmat))
    x, wq, a, ks, bias = k10_operands(g, device, BATCH, 64, 256, 256, torch.bfloat16)
    k10_one = median_ms_device(lambda: ic.int8_conv(x, wq, a, ks, bias, torch.bfloat16))
    del amat, bmat, x, wq
    ops = sum(2 * BATCH * sz * sz * 9 * ci * co for _, ci, co, sz in INT8_LAYERS)
    print(f"[phase 20] on {card}: int8_conv over the 14 trunk layers at batch {BATCH} "
          f"(device medians of 20): {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s); bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; {ops:.3e} int8 operations at "
          f"1,979 TOP/s, the activations at 3.35 TB/s); plain version {plain:.3f} ms "
          f"(medians of {PLAIN_RUNS}); cuDNN's bf16 conv alone (no bias, no ReLU) of the "
          f"same layers {cudnn:.3f} ms; "
          f"enc3_2 (256->256 at 64x64): K10 {k10_one:.3f} ms, torch._int_mm of its im2col "
          f"({m}x{9 * 256} by {9 * 256}x256, the product alone) {int_mm:.3f} ms")
    out.update({"ms": ms, "plain_ms": plain, "library_ms": None, "cudnn_bf16_ms": cudnn,
                "int_mm_one_layer_ms": int_mm, "k10_one_layer_ms": k10_one, **bound})
    if against:
        from selectivenet_for_semantic_segmentation_binary_torch.scripts import (
            int8_conv_against)
        print(f"[phase 20] on {card}: int8_conv_against.run({against!r}), K10 of the other "
              f"build against this one, layer by layer in turns", flush=True)
        pair = int8_conv_against.run(against, device)
        out["other_ms"] = sum(r["other_ms"] for r in pair)
        out["ms_in_turns"] = sum(r["ms"] for r in pair)
        print(f"[phase 20] on {card}: K10 over the 14 layers in turns: the other build "
              f"{out['other_ms']:.3f} ms, this one {out['ms_in_turns']:.3f} ms "
              f"({out['other_ms'] / out['ms_in_turns']:.2f}x)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 20] K10 launches on the int8 path (counter set to 0 before the int8 "
          f"Predictors and read after the QAT step): {out['launches']}; K1 launches in the "
          f"int8 snet-eval: {out['k1_launches_int8']}; phase 20 took {out['seconds']:.1f} s")
    if out["launches"] == 0:
        raise AssertionError("the int8 path launched K10 no time")
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    against = None
    if argv:
        if len(argv) != 2 or argv[0] != "--against" or not os.path.isdir(argv[1]):
            raise SystemExit("usage: python3 chip_smoke.py [--against OTHER_KERNELS_DIR]")
        against = argv[1]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    from selectivenet_for_semantic_segmentation_binary_torch import kernels
    from selectivenet_for_semantic_segmentation_binary_torch.ops import bn_stats as bs
    from selectivenet_for_semantic_segmentation_binary_torch.ops import conv_dw as cd
    from selectivenet_for_semantic_segmentation_binary_torch.ops import eval_metrics as em
    from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr as fc
    from selectivenet_for_semantic_segmentation_binary_torch.ops import fused_cbr_rows as fr
    from selectivenet_for_semantic_segmentation_binary_torch.ops import int8_conv as ic
    from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_bisect as tb
    from selectivenet_for_semantic_segmentation_binary_torch.ops import transposed_cbr as tc
    from selectivenet_for_semantic_segmentation_binary_torch.scripts.timing import card as card_of

    device = torch.device("cuda", 0)
    # phase 1
    card = card_of()
    print(card)
    print(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"capability {torch.cuda.get_device_capability(0)}")

    # phase 2: a fresh build from the checkout's sources, one nvcc each
    sources = (KERNEL_SOURCE, CBR_SOURCE, DW_SOURCE, BN_SOURCE, TC_SOURCE, TB_SOURCE,
               INT8_SOURCE)
    names = tuple(os.path.basename(src)[:-3] for src in sources)
    for name in names:
        if os.path.exists(kernels.library_path(name)):
            os.remove(kernels.library_path(name))
    t0 = time.perf_counter()
    kernels.build_all(names)
    print(f"[phase 2] nvcc built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        with open(os.path.join(kernels.BUILD_DIR, f"{name}.log")) as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[phase 2] {name}: {line.strip()}")

    worst = phase_kernel_exact(torch, em, device)
    models, step, batch, launches = phase_slice(torch, em, device)
    times = phase_timings(torch, em, models, step, batch, card, against)
    del models, step, batch
    cbr_worst = phase_cbr_kernel(torch, fc, device)
    cbr_launches, steps, train_batch = phase_train(torch, fc, device)
    cbr_times = phase_train_timings(torch, fc, device, steps, train_batch, card)
    del steps, train_batch
    torch.cuda.empty_cache()
    rows_worst = phase_rows_kernel(torch, fr, device)
    dw_worst = phase_dw_kernel(torch, cd, device)
    bn_worst = phase_bn_kernel(torch, bs, device)
    torch.cuda.empty_cache()
    protos = phase_proto_benches(torch, fr, cd, bs, card, against)
    torch.cuda.empty_cache()
    tc_worst = phase_transposed_cbr(torch, tc, device)
    tb_worst = phase_bisect(torch, device)
    torch.cuda.empty_cache()
    transposed = phase_transposed_entry_points(torch, tc, tb, card, against)
    torch.cuda.empty_cache()
    phase_serving(torch, device, card)
    torch.cuda.empty_cache()
    analysis = phase_analysis(torch, fc, device, card)
    torch.cuda.empty_cache()
    inputs = phase_inputs(torch, fc, em, device, card)
    torch.cuda.empty_cache()
    tools = phase_tools(torch, fc, em, device, card)
    torch.cuda.empty_cache()
    int8 = phase_int8(torch, ic, em, device, card, against)

    for name in ("jax", "selectivenet_for_semantic_segmentation_binary_tpu"):
        if name in sys.modules:
            raise AssertionError(f"the port imported {name}")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s wall")
    times["launches"], cbr_times["launches"] = launches, cbr_launches
    cbr_times["launches_analysis"] = analysis["launches"]
    times["launches_inputs"], cbr_times["launches_inputs"] = (inputs["launches_k1"],
                                                              inputs["launches_k2"])
    times["launches_tools"], cbr_times["launches_tools"] = (tools["launches_k1"],
                                                            tools["launches_k2"])
    times["launches_int8"] = int8["k1_launches_int8"]
    records = {"eval_metrics": times, "fused_conv_stats": cbr_times, **protos, **transposed,
               "int8_conv": int8}
    entries = (
        ("eval_metrics", KERNEL_SOURCE, TPU_KERNEL, worst),
        ("fused_conv_stats", CBR_SOURCE, CBR_TPU_KERNEL, cbr_worst),
        ("fused_cbr_rows", ROWS_SOURCE, ROWS_TPU_KERNEL, rows_worst),
        ("conv_dw", DW_SOURCE, DW_TPU_KERNEL, dw_worst),
        ("bn_stats", BN_SOURCE, BN_TPU_KERNEL, bn_worst),
        ("transposed_cbr_v1", TC_SOURCE, TC_TPU_KERNEL["v1"], tc_worst["v1"]),
        ("transposed_cbr_v2", TC_SOURCE, TC_TPU_KERNEL["v2"], tc_worst["v2"]),
        *((f"transposed_bisect_{k}", TB_SOURCE, TB_TPU_KERNEL[k], tb_worst[k])
          for k in ("K7", "K8", "K9")),
        ("int8_conv", INT8_SOURCE, INT8_TPU_KERNEL, 0.0),
    )
    kernel_records = []
    for name, source, tpu, err in entries:
        r = records[name]
        kernel_records.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": r["launches"], "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("one_call_cases", "ms_on_one_call_cases",
                                 "launches_analysis", "launches_inputs", "launches_tools",
                                 "launches_int8", "cudnn_bf16_ms", "int_mm_one_layer_ms",
                                 "k10_one_layer_ms", "other_ms", "ms_in_turns")
                 if k in r}})
    print(json.dumps({"kernels": kernel_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
