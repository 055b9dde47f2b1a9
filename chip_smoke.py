#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives ``lowlight_image_enhancement_tpu_torch`` only (no JAX):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``lowlight_image_enhancement_tpu_torch/
   csrc`` (nvcc, one process per source, all started together);
3. forward kernel phase: holds K1 (``nafblk_a``), K2 (``nafblk_b``) and
   the whole block K1 -> SCA -> K2 against their plain PyTorch versions on
   the card, at every width of a 512x512, N=2 forward (C=32@512^2 ...
   C=512@32^2) and at the width-64 configuration's C=1024@32^2, in fp32
   and bf16, and times kernel and plain version (CUDA events, median
   after warm-up) beside the bound from bytes and FLOPs. In bf16 (the
   tensor-core route) K1's two stages are held apart -- its fp32 ``t``
   against ``plain_a_front`` and its g and sums against ``plain_a_dw`` of
   that ``t`` -- here and at every shape of the backward phase; the FMA
   route runs at a bf16 C=24 (no multiple of 16), and a ``dw_expand=1``
   block must run unfused on the card;
4. backward kernel phase: the same for K1, K2, K3 (``nafblk_p1``), K4
   (``nafblk_p2``) and the whole block backward (``NAFBlockFunction`` vs
   the plain backward) at every width of a 384x384, N=2 training crop
   (C=32@384^2 ... C=512@24^2) and of one N=1 image, a data-parallel
   rank's share of it (path DP), at the width-64 configuration's
   C=1024@32^2, at C=64@20^2 (a side that leaves K4 ragged edge tiles),
   at NAFSSR's C=48 with 30x90 pixels and N=16 and at the bottom of
   NAFNetTPU's trunk, C=1024@12^2, checking dz, da, dx and every weight
   grad;
4b. narrow-channel phase: the same at C = 8, 24, 40, 12, 6 and 10 (no
   multiples of 16: in bf16 all four kernels take the FMA route; 6 and
   10 are no multiples of 4 either, and the matrices' rows are padded),
   F = C on 2xCx64^2 and 2xCx20^2 and F = 2C on 2xCx64^2, fp32 and bf16,
   with the route that each of K1-K4 took named by its device kernels;
5. serving phase: ``RestorationServer`` on ``NewBPNAFNet`` (width 32,
   full depth: 36 NAFBlocks) in bf16 with seeded random weights answers 8
   mixed-size requests (one through the tiled path); checks shapes,
   finiteness, that every NAFBlock forward went through K1+K2 (launch
   counts) on the tensor-core route (the device kernels of one request
   under the profiler), and one request against the model's eager
   (plain) path;
5a. path E (the export slice's main path): ``export_model`` of that
   ``NewBPNAFNet`` (weights re-seeded) at buckets 256x384 and 512x512, a
   fresh ``ExportedModel`` of the directory serving a 256x384 and a
   500x500 request and ``predict_batch`` over both: 36 K1 and 36 K2 op
   nodes in each program, 36 launches of each per exported forward on the
   tensor-core route, exported against live (equal bits, else 2^-6 of
   max|ref|, printed), a swapped ``params.npz`` giving the live output of
   the re-seeded weights; export seconds, file sizes, ms per request
   exported and live;
5b. path C: ``NAFNetLocal`` (TLC) at NAFNet's SID configuration in bf16
   with seeded random weights on a 1x3x512^2 request: with a window >= 2x
   the image it equals the fused ``NAFNet`` of the same weights (36 K1/K2
   launches) within the served bf16 bar and launches no K1-K4; at the
   recipe's window of 384 its output is finite, again with no launch;
6. training phase: the train step of ``configs/sid_newbp_mono_selfcontained
   .yml`` (``NewBPNAFNet`` in bf16, ``HybridLossPlus`` with the random
   bf16 VGG19 trunk, AdamW + clip 0.01 on the cosine schedule) on one
   seeded synthetic 2x3x384x384 batch: 1 warm-up and 3 timed steps;
   checks finite logs, 36 launches of each of K1-K4 per step, K1-K4 on
   the tensor-core route in the traced step (their device kernels by
   name), a falling loss, fp32 gradients through the kernels against the
   eager block path, and one eval forward;
6b. path D: ``network_g`` of ``configs/debug/sid_newbp_mono_debug.yml``
   (width 8: blocks at C = 8, 16, 32) under the same train block in bf16,
   one step after a warm-up on a seeded 2x3x128x128 batch: finite logs,
   one launch of each of K1-K4 per block, and in its traced step both
   routes (the C=8 blocks on the FMA kernels, the others on the tensor
   cores);
6c. path T: the user's training entry point, ``Trainer(opt).train()``, on
   ``configs/sid_newbp_mono_selfcontained.yml`` over a seeded synthetic
   SID tree (``make_synthetic_sid``: 4 train and 2 val pairs at 512^2,
   laid out as the config's ``SID_ROOT``), 4 iterations at full width
   and depth with batches of 2 384^2 crops from the packs through the
   device prefetcher: the native pack reader, 36 launches of each of
   K1-K4 per step (their tensor-core kernels in a traced step), finite
   logs, checkpoints at 2 and 4, validation at 4 with the config's four
   metrics on the two full val images, the restore of step 2 bit for
   bit, and a second Trainer that resumes at 2 and reaches 4; prints
   ms/step, data ms/step and the validation's wall time beside the
   training phase's ms/step;
6d. path A: ``Trainer(opt).train()`` on ``configs/sid_nafnet_tpu.yml``,
   ``sid_unet.yml`` (under ``LLIE_MAXPOOL_IMPL=kernel_bwd``) and
   ``sid_swinir.yml`` at full width and depth in bf16 over a synthetic SID
   tree like path T's (a seeded random VGG19 through ``$LLIE_VGG19_NPZ``
   for the perceptual term), 4 iterations each: launches per step
   (NAFNetTPU 36 of each of K1-K4 on the tensor cores; UNet 7 of K8: its
   3 downs and the VGG19 trunk's 4 pools; SwinIR none), finite logs, a
   checkpoint, the validation with each config's metrics, ``test.py`` on
   the saved ``net_g_latest.pth``; ms/step, data ms/step and the device's
   busy time and idle share of a traced step, beside path T's ms/step;
6e. the CLI: ``python -m lowlight_image_enhancement_tpu_torch.train -opt
   configs/debug/sid_newbp_mono_debug.yml`` in a subprocess from a
   temporary directory (16 iterations on the card, the self-provisioned
   debug fixtures), then ``test.py`` on its ``net_g_latest.pth``;
7. LayerNorm and pool kernel phase: holds K5 (``ln_fwd``), K6 (``ln_bwd``),
   K7 (``relu_pool_fwd``) and K8 (``pool_bwd``, with and without the relu)
   against their plain versions in fp32 and bf16: the LN kernels at the
   five Baseline widths of a training crop (C=32@384^2 ... C=512@24^2,
   N=2) and of a served batch (C=32@512^2 ... C=512@32^2), at NAFSSR's
   C=48 with 30x90 pixels and N=16, at C=1024@32^2 and at a ragged
   C=64@20x20; the pool kernels (exact equality) at the four VGG19 pool
   shapes, at UNetSID's three (C=32@384^2, 64@192^2, 128@96^2), at an odd
   H and W, with ties, with NaNs in some windows, at
   W=50 and W=40 (K7's 2-element loads and 8-byte stores) and, for K7,
   with x one element past a 16-byte boundary; K7's geometry printed;
   times each beside its plain version, its bound and the one library
   call that computes the same function;
8. path P: the training step of 6. (1 warm-up and 2 timed steps) with
   the perceptual trunk's pools on ``kernel_fused`` (8 launches of K7 and
   4 of K8 per step) and then on ``kernel_bwd`` (4 of K8, none of K7),
   and the perceptual term and its
   gradient held equal under the three pool options in fp32;
9. path B: ``Baseline`` at the published width-32 configuration under the
   same recipe in bf16: training steps (72 launches of K5 and of K6 per
   step), one eval forward, the fp32 gradient of every parameter through
   K5/K6 against the same model with ``LayerNorm2d`` on the plain version,
   and the 8 served requests (one through the tiled path), every one held
   against the same request served with the plain LayerNorm, in bf16 and
   in fp32;
10. path S: ``NAFSSR`` of ``configs/stereo_nafssr.yml`` (width 48, 16
   blocks, drop-path 0.1 from a seeded generator) with its AdamW / cosine
   / MSE train block on a seeded synthetic 16x6x30x90 batch: training
   steps (32 launches of each of K1-K6 per step), one eval forward, and
   the same fp32 gradient check;
9b. path B export: that ``Baseline`` through ``export_model`` at one
   256x384 bucket and a fresh ``ExportedModel``: 72 K5 op nodes and 72
   launches per forward, exported against live;
10b. path R: ``Trainer(opt).train()`` on ``configs/stereo_nafssr.yml``
   unchanged, ``STEREO_ROOT`` at a synthetic stereo tree
   (``make_synthetic_stereo``, its PNG rows cycling through filters 0-4),
   4 iterations: every view defiltered by the native
   ``native/pngcodec.cpp`` (none by the Python fallback), 32 launches of
   each of K1-K6 per step, finite logs, the validation's PSNR; ``LowlightModel`` (the
   config's ``model_type``) for 2 steps on the same loader and ``test()``
   (``[N, 6, 2H, 2W]``); ``demo_ssr`` in a subprocess on one L/R pair (two
   PNGs at 2x);
10c. the video path on the card: ``flow_warp`` at 1x256x256x64 and
   ``duf_downsample`` of a 7-frame 3x256x256 clip against the CPU (1e-5);
11. path M: the evaluation metrics. The flagship ``NewBPNAFNet`` (bf16,
   seeded) through ``metrics.compute_metrics`` over the two 512^2
   validation pairs of path T's synthetic SID tree, with the P2 raw PSF,
   LPIPS-vgg and the sRGB conversion: every metric finite, 36 launches of
   K1 and K2 per forward; LPIPS alex/vgg and InceptionV3 pool3 on the card
   against the same modules on the CPU; the VGG19 FID extractor under
   ``kernel_fused`` (4 launches of K7 a call) against ``reduce_window``;
   NIQE; ``count_flops`` of the forward at 1x3x512^2 (meta tensors)
   against its analytic MAC count; wall ms of each metric, the forward's
   latency, LPIPS-vgg and Inception times (and at 1424x2128, a quarter of
   a SID Sony frame) with their achieved fp32 rates;
12. path L: the training step of 6. with ``hybrid_opt.use_lpips: true``
   (``w_lpips`` 0.05, random LPIPS-vgg in fp32): finite positive
   ``l_lpips``, 36 launches of each of K1-K4 per step on the tensor
   cores, a falling loss, ms/step beside the training phase's, and the
   LPIPS term's input gradient on the card against the CPU in fp64 (the
   fp32 readings printed);
13. paths DP and SP (``parallel/``; this slice's main path is DP):
   (a) the flagship step in this process without a mesh, then in a
   ``torch.distributed`` world of 1 on NCCL (``init_multihost``), 1 warm-up,
   3 timed and 1 traced step each: equal parameters bit for bit, 36
   launches of each of K1-K4 a step on the tensor cores, 1-8 bulk
   all-reduces of 0.95-1.10x the fp32 gradient bytes and no bulk
   all-gather (``parallel.introspect.collective_stats`` of the traced
   step); SP at world 1: ``nafnet_apply_spatial`` of the serving
   ``NewBPNAFNet`` in fp32 (seeded) on one SID Sony frame, 1x3x2848x4256,
   against the single-device forward of the unfused blocks (1e-4 of
   max|ref|), 72 K5 launches a forward. Then one spawned world of two
   ranks over gloo on the one card (NCCL refuses two ranks on one GPU)
   runs in turn: (b) the same steps with one image a rank (equal
   parameters on both, the first step's all-reduced gradients equal, bit
   for bit in every leaf, to the mean of the two single-image steps of
   one process -- K1-K4 at N=1 are held against their plain versions in
   the backward phase -- their distance from the one-process 2-image
   step per leaf printed, l_total within 1e-2 of its); (c) ZeRO-1 (parameters within 2e-6 of (b)'s, the
   optimizer state per rank against (b)'s, a bulk all-gather); SP (each
   rank's output against world 1's, 72 K5 launches, peak memory against
   world 1's); ``Trainer(opt).train()`` of the flagship config with
   ``train.zero1`` over path T's synthetic tree (center crops, 2
   iterations an epoch): 4 iterations, checkpoints at 2, validation at 4
   through ``dist_validate``, a resume at 2 that gives iterations 3-4's
   l_total again; ms per step of (a)-(c) by the host clock (no speed
   claimed: the gloo ranks stage every collective through host memory);
14. ``torchrun --standalone --nproc_per_node=1 -m
   lowlight_image_enhancement_tpu_torch.train -opt
   configs/debug/sid_newbp_mono_debug.yml --launcher pytorch`` (as
   ``python -m torch.distributed.run``): a world of 1 on NCCL, rc 0;
15. the serving mesh and the sharded export at one device:
   ``RestorationServer(mesh=create_mesh(devices=["cuda:0"]))`` serves the 8
   requests equal to the server without a mesh (36 K1/K2 launches a
   forward); ``export_model(..., mesh=)`` records ``{"axis": "data",
   "size": 1}`` and a fresh ``ExportedModel`` serves ``predict_batch``
   against live;
16. path U (the user's tools, ``lowlight_image_enhancement_tpu_torch/
   tools``): a seeded PNG tree of 4 SID-named 512^2 pairs ->
   ``tools/prepare_sid_manifest.py`` -> ``create_sid_pack`` ->
   ``debug_dataset``, and ``SonySIDDataset`` reading every val pair back
   equal to its PNGs; ``evaluate`` of the serving ``NewBPNAFNet`` (full
   width and depth, bf16, seeded, a ``.pth``) over the 2 val pairs: 36 K1
   and 36 K2 launches a forward on the tensor cores, the report within
   1e-6 of a direct ``compute_metrics`` with the same weights, and
   ``--identity``; ``profile_train`` at its defaults (2x512^2, width 32,
   bf16; 36 launches of each of K1-K4 a step, a traced run on the tensor
   cores only); ``profile_step_families`` naming K1-K4's device kernels;
   ``debug_overfit --steps 50`` (both phases falling; K1-K4 on the FMA
   route in fp32); ``train_pipeline_e2e --steps 30 --workers 2`` (its
   three rates; 36 launches of K1-K4 a step); ``make_grain_loader(
   worker_count=2)`` over the packs into ``prefetch_to_device``, equal to
   the host batches; ``probe_backend() == "cuda"``. Prints a path_U JSON
   line.

Every kernel row carries two times: ``ms``, CUDA events around the
wrapper (host time included), and ``device_ms``, the kernel's own device
kernels read by ``torch.profiler`` ("not measured" where the profiler
shows no device time or keeps losing records), with the split by device
kernel (K1-K4 and K6 print it). K1-K4 and K6 are called twice at every
shape and must give the same bits; the tile arithmetic of the K1-K4
wrappers is held against the built kernels' shared memory and occupancy,
and K6's blocks per SM against the built kernel's occupancy, the FMA
route's pixels per block of K3/K4 against the built library's. After the
timed steps of every training path one more step runs under the profiler:
the device's busy time and its idle share of the step.

Any failed check raises, so the script exits non-zero. It prints a JSON
line ``{"kernels": [...]}`` and the card line before the last line, and
as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.losses import assert_finite_logs
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock
from lowlight_image_enhancement_tpu_torch.ops import _build
from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from lowlight_image_enhancement_tpu_torch.ops import pool
from lowlight_image_enhancement_tpu_torch.serving import RestorationServer
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.schedules import (
    make_schedule,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    create_train_state,
    hybrid_batch_kwargs,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_hybrid_loss,
    build_training_losses,
)

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s by operand type (bf16 on the tensor cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (C, side, NAFBlocks at this width in one NewBPNAFNet pass): enc
# (2,2,4,8), 12 middle, dec (2,2,2,2); serving on 512x512, training on the
# recipe's 384x384 crops
MAIN_PATH = [(32, 512, 4), (64, 256, 4), (128, 128, 6), (256, 64, 10),
             (512, 32, 12)]
TRAIN_PATH = [(32, 384, 4), (64, 192, 4), (128, 96, 6), (256, 48, 10),
              (512, 24, 12)]
# the width-64 configuration's middle stack (configs/sid_nafnet_w64.yml)
WIDE = (1024, 32)
# a side that is no multiple of K4's 12-pixel tile (ragged edge tiles)
RAGGED = (64, 20)
BATCH = 2
# the bottom of NAFNetTPU's trunk (configs/sid_nafnet_tpu.yml: width 64
# after a 2x2 space-to-depth of a 384^2 crop): its 12 middle blocks at
# C=1024@12^2, fewer pixels than one pixel tile of some bf16 kernels (its
# C=512 blocks run at 24^2, TRAIN_PATH's last width)
TPU_BOTTOM = (BATCH, 1024, 12, 12, 12, "nafnet_tpu")
# |kernel - plain| <= TOL * max|plain|: fp32 differs only by summation
# order; bf16 allows 4 bf16 ulps at the top of the range (a rounding of
# an operand or of the stored result may land on the other side).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# a served output against the same request on a plain path of the model:
# |kernel - plain| <= SERVE_TOL * max(1, max|plain|)
SERVE_TOL = {torch.bfloat16: 0.1, torch.float32: 1e-3}
SERVE_SHAPES = [(512, 512)] * 4 + [(600, 400)] * 2 + [(256, 384),
                                                      (1500, 1000)]
TRAIN_CONFIG = Path(__file__).resolve().parent / "configs" / \
    "sid_newbp_mono_selfcontained.yml"
STEREO_CONFIG = TRAIN_CONFIG.with_name("stereo_nafssr.yml")
TRAIN_STEPS = 3
# the NAFNet paper's Baseline-width32 (megvii-research/NAFNet,
# options/train/SIDD/Baseline-width32.yml)
BASELINE_W32 = {"type": "Baseline", "width": 32,
                "enc_blk_nums": [2, 2, 4, 8], "middle_blk_num": 12,
                "dec_blk_nums": [2, 2, 2, 2], "dw_expand": 1,
                "ffn_expand": 2}
# NAFSSR's blocks (configs/stereo_nafssr.yml): 16 pairs of 30x90 views at
# C=48, each of the 16 blocks applied to both views; 30 and 90 are no
# multiples of K4's 12-pixel tile
NAFSSR_BLOCK = (16, 48, 30, 90, 32, "nafssr")
# (N, C, H, W, LayerNorms at this shape in one Baseline-width32 forward):
# the 384x384 training crop, then a served 512x512 batch
LN_SHAPES = [(BATCH, c, s, s, 2 * n, "baseline") for c, s, n in TRAIN_PATH]
LN_SHAPES += [(BATCH, c, s, s, 2 * n, "baseline_serve")
              for c, s, n in MAIN_PATH]
LN_SHAPES += [NAFSSR_BLOCK, (BATCH, *WIDE, WIDE[1], 0, "w1024"),
              (BATCH, *RAGGED, RAGGED[1], 0, "ragged")]
# (N, C, H, W, pools at this shape in one VGG19 pass, kind of input)
POOL_SHAPES = [(BATCH, 64, 384, 384, 1, "vgg"),
               (BATCH, 128, 192, 192, 1, "vgg"),
               (BATCH, 256, 96, 96, 1, "vgg"), (BATCH, 512, 48, 48, 1, "vgg"),
               (BATCH, 64, 37, 51, 0, "odd"), (BATCH, 64, 96, 96, 0, "ties"),
               (BATCH, 64, 96, 96, 0, "nan"),
               # K7's edges: W % 8 != 0 (a 100-byte bf16 row pitch: 2-element
               # loads), W % 16 == 8 (8-byte bf16 stores, a short last group)
               (BATCH, 64, 50, 50, 0, "w50"), (BATCH, 64, 40, 40, 0, "w40"),
               # UNetSID's three downs (configs/sid_unet.yml, 384^2 crops),
               # K8 under LLIE_MAXPOOL_IMPL=kernel_bwd
               (BATCH, 32, 384, 384, 1, "unet"),
               (BATCH, 64, 192, 192, 1, "unet"),
               (BATCH, 128, 96, 96, 1, "unet")]
PALLAS = "lowlight_image_enhancement_tpu/ops/pallas/"
CSRC = "lowlight_image_enhancement_tpu_torch/csrc/"
KERNELS = {
    "nafblk_a": ("K1", CSRC + "nafblock_fwd.cu", PALLAS + "nafblock.py:462"),
    "nafblk_b": ("K2", CSRC + "nafblock_fwd.cu", PALLAS + "nafblock.py:534"),
    "nafblk_p1": ("K3", CSRC + "nafblock_bwd.cu", PALLAS + "nafblock.py:579"),
    "nafblk_p2": ("K4", CSRC + "nafblock_bwd.cu", PALLAS + "nafblock.py:698"),
    "ln_fwd": ("K5", CSRC + "layernorm.cu", PALLAS + "layernorm.py:36"),
    "ln_bwd": ("K6", CSRC + "layernorm.cu", PALLAS + "layernorm.py:50"),
    "relu_pool_fwd": ("K7", CSRC + "pool.cu", PALLAS + "pool.py:84"),
    "pool_bwd": ("K8", CSRC + "pool.cu", PALLAS + "pool.py:92"),
}
WRAPPERS = {"nafblk_a": ops.call_a, "nafblk_b": ops.call_b,
            "nafblk_p1": ops.call_p1, "nafblk_p2": ops.call_p2,
            "ln_fwd": ln.call_ln_fwd, "ln_bwd": ln.call_ln_bwd,
            "relu_pool_fwd": pool.call_relu_pool_fwd,
            "pool_bwd": pool.call_pool_bwd}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def launches() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def expect_launches(counts: dict, what: str, **expected: int) -> None:
    """Every kernel's count: the named ones as given, every other 0."""
    for k, n in counts.items():
        want = expected.get(k, 0)
        check(n == want, f"{what}: {k} launched {n} times, expected {want}")


def timed(fn, plain):
    """``(ms around the wrapper, ms of the plain version, device time by
    device kernel)`` of one kernel call."""
    return time_ms(fn), time_ms(plain), device_times(fn)


def timed_library(fn, calls: int = 1):
    """``(ms around the call, its device time by device kernel)``; the
    device time only where the main paths call the kernel at this shape
    (``calls``), else None."""
    return time_ms(fn), device_times(fn) if calls else None


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of ``fn`` (CUDA events), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


# the CUDA API calls that start a device kernel, as torch.profiler names
# them on the host side of a trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
PROFILER_TRIES = 3
# Where a window of kernel calls came back short, the record it lacked was
# that of the first kernel launched in it, so a window's work starts this
# much after the window. Windows that still lack records are taken again.
PROFILER_SLACK_S = 0.005


def device_records(averages) -> dict:
    """``{name: (records, microseconds in all)}`` of the device side of a
    ``torch.profiler`` window's ``key_averages()``: kernels, and copies
    and fills as ``Memcpy ...`` and ``Memset``. A kernel's name is its
    identifier without the anonymous namespace, template and argument
    lists."""
    out: dict = {}
    for ev in averages:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total = getattr(ev, "self_device_time_total", None)
        if total is None:
            total = ev.self_cuda_time_total
        if total <= 0 or ev.count <= 0:
            continue
        name = ev.key.replace("(anonymous namespace)::", "")
        name = re.sub(r"<.*", "", name)
        name = re.sub(r"^void\s+", "", name.split("(")[0]).strip()
        count, t = out.get(name, (0, 0.0))
        out[name] = (count + ev.count, t + total)
    return out


def device_times(fn, iters: int = 5) -> dict:
    """Device time (ms per call of ``fn``) by device kernel name over a
    profiler window of ``iters`` calls; ``fn`` is warm (:func:`time_ms` ran
    it). The profiler now and then loses records: a window counts only if
    every kernel was recorded a multiple of ``iters`` times, else it is
    taken again. Empty ("not measured") when ``PROFILER_TRIES`` windows in
    a row were short of records or showed no device time; no time is
    estimated."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_SLACK_S)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = device_records(prof.key_averages())
        if records and all(n % iters == 0 for n, _ in records.values()):
            return {k: t / iters / 1e3 for k, (_, t) in records.items()}
        print(f"  profiler window of {iters} calls taken again: records "
              f"{ {k: n for k, (n, _) in records.items()} }")
    return {}


def device_ms(times: dict):
    """The sum of a :func:`device_times` split, or "not measured"."""
    return sum(times.values()) if times else "not measured"


def show_split(what: str, times: dict) -> None:
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        times.items(), key=lambda kv: -kv[1]))
    print(f"  {what}: device {fmt_device(device_ms(times))} per call "
          f"[{parts}]")


def randomize_(module: torch.nn.Module, gen: torch.Generator,
               res_scale: float) -> None:
    """Seeded weights with non-trivial norms and residual scales (the zero
    init of beta/gamma would make every block an identity)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            r = torch.randn(p.shape, generator=gen, device=p.device)
            if leaf in ("beta", "gamma"):
                p.copy_(res_scale * r)
            elif ".norm" in f".{name}" and leaf == "weight":
                p.copy_(1.0 + 0.2 * r)
            elif leaf == "bias":
                p.copy_(0.1 * r)
            else:
                fan_in = p[0].numel()
                p.copy_(r / fan_in ** 0.5)


def err(got: torch.Tensor, ref: torch.Tensor, scale=None):
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    e = (got.float() - ref.float()).abs().max().item()
    s = ref.float().abs().max().item() if scale is None else scale
    return e, e / max(s, 1e-30)


def bound(kind: str, c: int, hw: tuple, dt: torch.dtype, n: int = BATCH,
          f: int = None):
    """Least time (ms) for one call's work: bytes (each input read once,
    each output written once) over the HBM rate vs the FLOPs of its
    matrix products (FFN width 2F, F = C unless given) over the operand
    type's peak. ``hw`` is ``(H, W)``. The weight matrices count at the
    size the wrapper hands them over in: the activation type's on the
    tensor-core route (bf16, ``ops.*_geometry`` gives a tile), fp32 on
    the FMA route; vectors and the weight grads K3/K4 write are fp32."""
    h, w = hw
    s = torch.tensor([], dtype=dt).element_size()
    f = c if f is None else f
    mma = {"nafblk_a": lambda: ops.k1_geometry(dt, n, c, h, w, built=True),
           "nafblk_b": lambda: ops.k2_geometry(dt, n, c, f, h * w,
                                               built=True),
           "nafblk_p1": lambda: ops.p1_geometry(dt, n, c, f, h * w),
           "nafblk_p2": lambda: ops.p2_geometry(dt, n, c, h, w)}[kind]()[0]
    m = s if mma else 4                       # bytes of a matrix element
    act = n * c * h * w
    px = n * h * w
    nc = 4 * n * c                            # one [N, C] fp32 array
    mats = c * c + 3 * f * c                  # W3, W4 [2F, C], W5 [C, F]
    vecs = 6 * c + 2 * f                      # b3, w2n, b2n, b5, beta,
    # gamma; b4 [2F]
    if kind == "nafblk_a":     # x in, g out; W1, kdw, vectors; sums out
        nbytes = 2 * act * s + m * 2 * c * c + 4 * (18 * c + 6 * c) + nc
        flops = px * (4 * c * c + 36 * c)
    elif kind == "nafblk_b":   # x, g in, out; W3, W4, W5, vectors; att
        nbytes = 3 * act * s + m * mats + 4 * vecs + nc
        flops = px * (2 * c * c + 6 * f * c)   # conv3, conv4, conv5
    elif kind == "nafblk_p1":  # x, g, dout in, dz out; W3-W5, vectors;
        # att in, da out; fp32 grads of W3-W5 and the vectors out
        nbytes = 4 * act * s + m * mats + 4 * vecs + 4 * (mats + vecs) \
            + 2 * nc
        # recompute, input-side products and weight grads, each
        # 2 C^2 + 6 C F (24 C^2 in all at F = C)
        flops = px * 3 * (2 * c * c + 6 * f * c)
    else:                      # x, dz in, dx out; dgc, att in; W1, W3
        # (3C^2), kdw and 7 vectors (25C) in; fp32 grads of W1, the
        # 11 x 2C taps (kdw, bk, b1) and w1n, b1n out (2C^2 + 24C)
        nbytes = (3 * act * s + m * 3 * c * c + 4 * 25 * c
                  + 4 * (2 * c * c + 24 * c) + 2 * nc)
        flops = px * (14 * c * c + 108 * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def fmt_device(dev) -> str:
    return f"{dev:.4f} ms" if isinstance(dev, float) else str(dev)


def report(kind, rows, c, side, dt, blocks, e, t_k, t_p, split, path,
           n=BATCH, hw=None, f=None):
    h, w = hw or (side, side)
    b_ms, b_by = bound(kind, c, (h, w), dt, n, f)
    dev = device_ms(split)
    rows.setdefault(kind, []).append(dict(
        path=path, n=n, c=c, f=c if f is None else f, side=side, h=h, w=w,
        dtype=str(dt)[6:],
        blocks=blocks, err=e, ms=t_k, device_ms=dev, device_split=split,
        plain_ms=t_p, bound_ms=b_ms, bound_by=b_by))
    print(f"  N={n:2d} C={c:4d} {h}x{w} {str(dt)[6:]:8s} {kind}: kernel "
          f"{t_k:.4f} ms (device {fmt_device(dev)})  plain {t_p:.4f} ms  "
          f"bound {b_ms:.4f} ms ({b_by})")


def show(checks, c, side, dt):
    tol = TOL[dt]
    dims = side if isinstance(side, str) else f"{side}x{side}"
    for name, (e, rel) in checks.items():
        print(f"  C={c:4d} {dims} {str(dt)[6:]:8s} {name:14s} "
              f"max_abs={e:.3e} rel={rel:.3e} tol={tol:.1e}")
        check(rel <= tol, f"{name} C={c} {dt}: rel {rel} > {tol}")


def hold_forward_geometry(c: int) -> None:
    """The K1/K2 wrappers' tile arithmetic against the built kernels:
    shared memory as the kernels sum it at every tile that fits, and the
    blocks-per-SM tables (which the CPU tests of the geometry read; the
    wrappers on CUDA ask the built kernels) against the runtime's count,
    K1's depthwise kernel's too."""
    if c % 16:
        return
    lib = _build.load("nafblock_fwd")
    for tile in ops.P1_TILES:
        for what, smem, per_sm, built, runtime in (
                ("K1 front", ops.k1_smem_bytes(c, tile),
                 ops.k1_blocks_per_sm(c, tile), lib.nafblk_a_mma_smem(c, tile),
                 lib.nafblk_a_mma_blocks_per_sm(c, tile)),
                ("K2", ops.k2_smem_bytes(c, c, tile),
                 ops.k2_blocks_per_sm(c, c, tile),
                 lib.nafblk_b_mma_smem(c, c, tile),
                 lib.nafblk_b_mma_blocks_per_sm(c, c, tile))):
            if smem > ops.P1_SMEM_LIMIT:
                continue
            print(f"  {what} bf16 C={c:4d} tile {tile:2d}: {smem} bytes of "
                  f"shared memory, {runtime} blocks per SM")
            check(built == smem and runtime == per_sm,
                  f"{what} C={c} tile {tile}: ops/nafblock.py counts {smem} "
                  f"bytes and {per_sm} blocks per SM, the built kernel "
                  f"{built} and {runtime}")
    dw = lib.nafblk_a_dw_blocks_per_sm()
    check(dw == ops.K1_DW_BLOCKS_PER_SM, f"K1 depthwise kernel: {dw} blocks "
          f"per SM, ops/nafblock.py counts {ops.K1_DW_BLOCKS_PER_SM}")


def forward_checks(x, p, pk, hw, dt) -> tuple:
    """K1 and K2 on ``x`` against their plain versions: ``(checks, g,
    sums, att)`` with ``g, sums`` the plain K1's and ``att`` the SCA
    attention from them (K2's input). ``pk`` holds the matrices as
    NAFBlockFunction hands them over. On the tensor-core route K1's two
    stages are held apart (the depthwise stage on the kernel's own ``t``);
    every kernel is called twice and must give equal bits."""
    n, c, s = x.shape
    mma = ops.k1_geometry(dt, n, c, *hw)[0] > 0
    with torch.no_grad():
        out_k1 = ops.call_a(x, pk, hw, return_t=mma)
        g_2, sums_2 = ops.call_a(x, pk, hw)
        g, sums = ops.plain_a(x, p, hw)
        att = ops.sca_attention(sums, p, s)
        out_k = ops.call_b(x, g, att, pk)
        out_2 = ops.call_b(x, g, att, pk)
        out_p = ops.plain_b(x, g, att, p)
        if mma:
            t_p = ops.plain_a_front(x, p)
            g_d, sums_d = ops.plain_a_dw(out_k1[2], p, hw, dt)
    torch.cuda.synchronize()
    g_k, sums_k = out_k1[:2]
    # no float atomics in K1 or K2: a second call gives the same bits
    check(torch.equal(g_k, g_2) and torch.equal(sums_k, sums_2),
          f"K1 C={c} {hw} {dt}: two calls differ")
    check(torch.equal(out_k, out_2), f"K2 C={c} {hw} {dt}: two calls differ")
    # the SCA means against max|mean| of the reference's own
    checks = {"nafblk_a": err(g_k, g), "sca_mean": err(sums_k / s, sums / s)}
    if mma:
        checks["a.front t"] = err(out_k1[2], t_p)
        checks["a.dw g"] = err(g_k, g_d)
        checks["a.dw mean"] = err(sums_k / s, sums_d / s)
    checks["nafblk_b"] = err(out_k, out_p)
    return checks, g, sums, att


def forward_phase(gen: torch.Generator, rows: dict) -> None:
    widths = [(c, s, n, "serve") for c, s, n in MAIN_PATH]
    widths.append((*WIDE, 0, "w64"))
    for c, side, nblk, path in widths:
        hw = side * side
        shw = (side, side)
        hold_forward_geometry(c)
        blk = NAFBlock(c).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        x32 = torch.randn((BATCH, c, hw), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            pk = ops.rounded_matrices(p, dt)
            checks, g_p, _, att = forward_checks(x, p, pk, shw, dt)
            with torch.no_grad():
                blk_k = ops.nafblock_fwd(x, p, shw)
                blk_p = ops.nafblock_fwd_reference(x, p, shw)
            torch.cuda.synchronize()
            checks["block"] = err(blk_k, blk_p)
            show(checks, c, side, dt)
            with torch.no_grad():
                t = {
                    "nafblk_a": timed(lambda: ops.call_a(x, pk, shw),
                                      lambda: ops.plain_a(x, p, shw)),
                    "nafblk_b": timed(lambda: ops.call_b(x, g_p, att, pk),
                                      lambda: ops.plain_b(x, g_p, att, p)),
                }
            for k, times in t.items():
                report(k, rows, c, side, dt, nblk, checks[k][0], *times, path)
            show_split(f"K1 {str(dt)[6:]} N={BATCH} C={c} {side}x{side}",
                       t["nafblk_a"][2])
            show_split(f"K2 {str(dt)[6:]} N={BATCH} C={c} {side}x{side}",
                       t["nafblk_b"][2])
        del blk, x32
    fma_route_in_bf16(gen)
    dw_expand_block_runs_unfused(gen)


def fma_route_in_bf16(gen: torch.Generator) -> None:
    """K1 and K2 in bf16 at a C that is no multiple of 16 take the FMA
    kernels of the first port, and agree with their plain versions."""
    n, c, side = BATCH, 24, 64
    check(ops.k1_geometry(torch.bfloat16, n, c, side, side) == (0, 0, 0)
          and ops.k2_geometry(torch.bfloat16, n, c, c, side * side) == (0, 0),
          "bf16 C=24 must take the FMA route")
    blk = NAFBlock(c).cuda()
    randomize_(blk, gen, 1.0)
    p = blk.packed()
    x = torch.randn((n, c, side * side), generator=gen, device="cuda").to(
        torch.bfloat16)
    checks, *_ = forward_checks(x, p, ops.rounded_matrices(p, torch.bfloat16),
                                (side, side), torch.bfloat16)
    show(checks, c, f"{side}x{side} FMA route", torch.bfloat16)


def dw_expand_block_runs_unfused(gen: torch.Generator) -> None:
    """A block with dw_expand=1, which the JAX package leaves unfused, runs
    its module graph on the card: no K1/K2 launch, the eager output."""
    blk = NAFBlock(32, dw_expand=1).cuda()
    randomize_(blk, gen, 1.0)
    x = torch.randn((BATCH, 32, 64, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        y = blk(x)
        y_eager = blk.forward_eager(x)
    torch.cuda.synchronize()
    expect_launches(launches(), "dw_expand=1 block")
    check(torch.equal(y, y_eager) and bool(torch.isfinite(y).all()),
          "dw_expand=1 block: output is not the eager path's")
    print(f"  NAFBlock(32, dw_expand=1) bf16 {tuple(x.shape)}: the module "
          f"graph, no K1/K2 launch")


def backward_checks(x, dout, p, pk, shw, dt) -> tuple:
    """K1-K4 on ``x`` and the whole block backward (NAFBlockFunction on
    the card) against their plain versions: ``(checks, g, att, dz, dgc)``
    with ``g, att, dz, dgc`` the plain versions' (the kernels' inputs).
    ``pk`` holds the matrices as NAFBlockFunction hands them over. K3 and
    K4 are called twice and must give equal bits."""
    n, c, hw = x.shape
    checks, g, sums, att = forward_checks(x, p, pk, shw, dt)
    m = sums / hw
    with torch.no_grad():
        dz_k, da_k, gk = ops.call_p1(x, g, dout, att, pk)
        dz_2, da_2, gk_2 = ops.call_p1(x, g, dout, att, pk)
        dz, da, gp = ops.plain_p1(x, g, dout, att, p)
        dwsca, dbsca, dgc = ops.sca_backward(da, m, p, hw)
        dx_k, g1k = ops.call_p2(x, dz, dgc, att, pk, shw)
        dx_2, g1k_2 = ops.call_p2(x, dz, dgc, att, pk, shw)
        dx, g1p = ops.plain_p2(x, dz, dgc, att, p, shw)
    torch.cuda.synchronize()
    # no float atomics in K3 or K4: a second call gives the same bits
    check(torch.equal(dz_k, dz_2) and torch.equal(da_k, da_2)
          and all(torch.equal(gk[k], gk_2[k]) for k in gk),
          f"K3 C={c} {shw} {dt}: two calls differ")
    check(torch.equal(dx_k, dx_2)
          and all(torch.equal(g1k[k], g1k_2[k]) for k in g1k),
          f"K4 C={c} {shw} {dt}: two calls differ")
    del dz_2, da_2, gk_2, dx_2, g1k_2
    checks["nafblk_p1"] = err(dz_k, dz)
    checks["p1.da"] = err(da_k, da)
    checks.update({f"p1.d{k}": err(gk[k], gp[k]) for k in gp})
    checks["nafblk_p2"] = err(dx_k, dx)
    checks.update({f"p2.d{k}": err(g1k[k], g1p[k]) for k in g1p})
    # the whole block backward: NAFBlockFunction on the card vs the
    # plain backward (K3 -> SCA -> K4 plain versions)
    xg = x.detach().requires_grad_(True)
    views = [p[k] for k in ops.PARAM_ORDER]
    got = torch.autograd.grad(ops.nafblock_fwd(xg, p, shw),
                              [xg, *views], dout)
    ref = {**gp, **g1p, "Wsca": dwsca, "bsca": dbsca}
    torch.cuda.synchronize()
    checks["block.dx"] = err(got[0], dx)
    worst = max((err(gv, ref[k]) for k, gv in
                 zip(ops.PARAM_ORDER, got[1:])), key=lambda e: e[1])
    checks["block.dparams"] = worst
    return checks, g, att, dz, dgc


# the training crop at N=2, then one image of it, a rank's share on path DP
BACKWARD_WIDTHS = ([(BATCH, c, s, s, n, "train") for c, s, n in TRAIN_PATH]
                   + [(1, c, s, s, n, "dp") for c, s, n in TRAIN_PATH]
                   + [(BATCH, *WIDE, WIDE[1], 0, "w64"),
                      (BATCH, *RAGGED, RAGGED[1], 0, "ragged"), NAFSSR_BLOCK,
                      TPU_BOTTOM])


def backward_phase(gen: torch.Generator, rows: dict) -> None:
    widths = BACKWARD_WIDTHS
    hold_fma_geometry({(c, c) for _, c, *_ in widths})
    for n, c, side, wide, nblk, path in widths:
        hw = side * wide
        shw = (side, wide)
        blk = NAFBlock(c).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        # the wrapper's tile arithmetic against the built kernel: shared
        # memory as the kernel sums it, blocks per SM as the runtime counts
        lib = _build.load("nafblock_bwd")
        check(lib.nafblk_smem_limit() == ops.P1_SMEM_LIMIT,
              "K3: shared-memory limit differs between ops/nafblock.py and "
              "csrc")
        for tile in ops.P1_TILES:
            smem = ops.p1_smem_bytes(c, c, tile)
            if smem > ops.P1_SMEM_LIMIT:
                continue
            per_sm = lib.nafblk_p1_mma_blocks_per_sm(c, c, tile)
            print(f"  K3 bf16 C={c:4d} tile {tile:2d}: {smem} bytes of shared "
                  f"memory, {per_sm} blocks per SM")
            check(lib.nafblk_p1_mma_smem(c, c, tile) == smem
                  and per_sm == ops.p1_blocks_per_sm(c, c, tile),
                  f"K3 C={c} tile {tile}: ops/nafblock.py counts {smem} bytes "
                  f"and {ops.p1_blocks_per_sm(c, c, tile)} blocks per SM")
        for tile in ops.P1_TILES if c % 16 == 0 else ():
            smem = ops.p2_smem_bytes(c, tile)
            if smem > ops.P1_SMEM_LIMIT:
                continue
            per_sm = lib.nafblk_p2_mma_blocks_per_sm(c, tile)
            print(f"  K4 bf16 C={c:4d} tile {tile:2d}: {smem} bytes of shared "
                  f"memory, {per_sm} blocks per SM")
            check(lib.nafblk_p2_mma_smem(c, tile) == smem
                  and per_sm == ops.p2_blocks_per_sm(c, tile),
                  f"K4 C={c} tile {tile}: ops/nafblock.py counts {smem} bytes "
                  f"and {ops.p2_blocks_per_sm(c, tile)} blocks per SM")
        hold_forward_geometry(c)
        x32 = torch.randn((n, c, hw), generator=gen, device="cuda")
        d32 = torch.randn((n, c, hw), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, dout = x32.to(dt), d32.to(dt)
            # the kernels get their matrices as NAFBlockFunction hands them
            # over
            pk = ops.rounded_matrices(p, dt)
            checks, g, att, dz, dgc = backward_checks(x, dout, p, pk, shw,
                                                       dt)
            show(checks, c, f"{side}x{wide} N={n}", dt)
            with torch.no_grad():
                t = {
                    "nafblk_a": timed(lambda: ops.call_a(x, pk, shw),
                                      lambda: ops.plain_a(x, p, shw)),
                    "nafblk_b": timed(lambda: ops.call_b(x, g, att, pk),
                                      lambda: ops.plain_b(x, g, att, p)),
                    "nafblk_p1": timed(
                        lambda: ops.call_p1(x, g, dout, att, pk),
                        lambda: ops.plain_p1(x, g, dout, att, p)),
                    "nafblk_p2": timed(
                        lambda: ops.call_p2(x, dz, dgc, att, pk, shw),
                        lambda: ops.plain_p2(x, dz, dgc, att, p, shw)),
                }
            for k, times in t.items():
                report(k, rows, c, side, dt, nblk, checks[k][0], *times, path,
                       n, shw)
            for tag, k in (("K1", "nafblk_a"), ("K2", "nafblk_b"),
                           ("K3", "nafblk_p1")):
                show_split(f"{tag} {str(dt)[6:]} N={n} C={c} {side}x{wide}",
                           t[k][2])
            show_split(f"K4 {str(dt)[6:]} N={n} C={c} {side}x{wide}",
                       t["nafblk_p2"][2])
        del blk, x32, d32


def hold_fma_geometry(widths) -> None:
    """The FMA route's pixels per block of K3 and K4 (ops/nafblock.py:
    ``p1_fma_pixels``, ``p2_fma_pixels``) against the built library's at
    every ``(C, F)`` of ``widths``, and the bf16 K4 depthwise kernel's
    blocks per SM against ops/nafblock.py's count."""
    lib = _build.load("nafblock_bwd")
    for c, f in widths:
        got = (lib.nafblk_p1_pixels(c, f), lib.nafblk_p2_pixels(c))
        want = (ops.p1_fma_pixels(c, f), ops.p2_fma_pixels(c))
        check(got == want, f"FMA route C={c} F={f}: the built kernels take "
              f"{got} pixels a block (K3, K4), ops/nafblock.py counts {want}")
    dw = lib.nafblk_p2_dw_blocks_per_sm()
    print(f"  K4 bf16 depthwise kernel: {dw} blocks per SM")
    check(dw == ops.P2_DW_BLOCKS_PER_SM, f"K4 depthwise kernel: {dw} blocks "
          f"per SM, ops/nafblock.py counts {ops.P2_DW_BLOCKS_PER_SM}")


# the device kernels of K3 and K4 on the tensor-core route and on the FMA
# route
K34_TENSOR_CORES = ("nafblk::k3_mma_kernel", "nafblk::k4_front_kernel",
                    "nafblk::k4_dw_kernel", "nafblk::k4_back_kernel")
K34_FMA = ("k3_kernel", "k4a_kernel", "k4b_kernel")
# C that is no multiple of 16: in bf16 all four kernels take the FMA route;
# 6 and 10 are no multiples of 4 either (the matrices' rows padded)
NARROW_C = (8, 24, 40, 12, 6, 10)
# a whole 64x64 image, and a side that is no multiple of K4's 12-pixel FMA
# tile or of 8
NARROW_SIDES = (64, 20)


def show_route(what: str, split: dict, mma: bool, names) -> None:
    """The route a kernel took, read from the device kernels of its timing
    window (``split``): the route its geometry chose (``mma``: the
    tensor-core kernels of ``names[0]``, else the FMA kernels of
    ``names[1]``), and none of the other's. "not measured" where the
    profiler kept losing records."""
    if not split:
        print(f"  {what}: route not measured (no complete profiler window)")
        return
    want, other = names if mma else names[::-1]
    ran = [k for k in want if k in split]
    wrong = [k for k in other if k in split]
    check(len(ran) == len(want) and not wrong, f"{what}: expected the "
          f"{'tensor-core' if mma else 'FMA'} route, ran {sorted(split)}")
    print(f"  {what}: {'tensor-core' if mma else 'FMA'} route "
          f"({', '.join(sorted(split))})")


def narrow_channels_phase(gen: torch.Generator, rows: dict) -> None:
    """K1-K4 and the whole block backward at C that is no multiple of 16,
    with the standard FFN (F = C) and a doubled one (F = 2C, at 64x64), on
    a whole 64x64 image and a ragged 20x20, in bf16 (the FMA route of all
    four kernels) and fp32, against their plain versions: 2^-6 / 1e-4 of
    max|ref|, equal bits on two calls; the route of all four named by their
    device kernels and their times kept. At C = 6 and 10 (no multiple of
    4) the kernels get their matrices' rows zero-padded by the wrappers,
    and the whole block runs through NAFBlockFunction, forward and
    backward (in ``backward_checks``)."""
    cases = [(c, ffn, side) for c in NARROW_C for ffn in (2, 4)
             for side in NARROW_SIDES if ffn == 2 or side == NARROW_SIDES[0]]
    hold_fma_geometry({(c, c * ffn // 2) for c, ffn, _ in cases})
    for c, ffn, side in cases:
        f = c * ffn // 2
        shw = (side, side)
        blk = NAFBlock(c, ffn_expand=ffn).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        x32 = torch.randn((BATCH, c, side * side), generator=gen,
                          device="cuda")
        d32 = torch.randn((BATCH, c, side * side), generator=gen,
                          device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, dout = x32.to(dt), d32.to(dt)
            # as NAFBlockFunction hands them over: rounded, and at C or F
            # % 4 != 0 with their rows padded once
            pk = ops.padded_matrices(ops.rounded_matrices(p, dt))
            checks, g, att, dz, dgc = backward_checks(x, dout, p, pk, shw,
                                                       dt)
            show(checks, c, f"{side}x{side} F={f}", dt)
            with torch.no_grad():
                t = {
                    "nafblk_a": timed(lambda: ops.call_a(x, pk, shw),
                                      lambda: ops.plain_a(x, p, shw)),
                    "nafblk_b": timed(lambda: ops.call_b(x, g, att, pk),
                                      lambda: ops.plain_b(x, g, att, p)),
                    "nafblk_p1": timed(
                        lambda: ops.call_p1(x, g, dout, att, pk),
                        lambda: ops.plain_p1(x, g, dout, att, p)),
                    "nafblk_p2": timed(
                        lambda: ops.call_p2(x, dz, dgc, att, pk, shw),
                        lambda: ops.plain_p2(x, dz, dgc, att, p, shw)),
                }
            for k, times in t.items():
                report(k, rows, c, side, dt, 0, checks[k][0], *times,
                       "narrow", BATCH, shw, f)
            tag = f"{str(dt)[6:]} N={BATCH} C={c} F={f} {side}x{side}"
            s = side * side
            show_route(f"K1 {tag}", t["nafblk_a"][2],
                       ops.k1_geometry(dt, BATCH, c, side, side)[0] > 0,
                       (K12_TENSOR_CORES[:2], K12_FMA[:1]))
            show_route(f"K2 {tag}", t["nafblk_b"][2],
                       ops.k2_geometry(dt, BATCH, c, f, s)[0] > 0,
                       (K12_TENSOR_CORES[2:], K12_FMA[1:]))
            show_route(f"K3 {tag}", t["nafblk_p1"][2],
                       ops.p1_geometry(dt, BATCH, c, f, s)[0] > 0,
                       (K34_TENSOR_CORES[:1], K34_FMA[:1]))
            show_route(f"K4 {tag}", t["nafblk_p2"][2],
                       ops.p2_geometry(dt, BATCH, c, side, side)[0] > 0,
                       (K34_TENSOR_CORES[1:], K34_FMA[1:]))
        del blk, x32, d32


def serve_mix(net, what: str, mesh=None, **per_forward: int) -> dict:
    """The 8-request mix through ``RestorationServer`` (over ``mesh`` when
    given): shapes, finiteness, 4 forward batches and ``per_forward``
    launches in each."""
    server = RestorationServer(net, device="cuda", mesh=mesh)
    rng = np.random.default_rng(SEED)
    images = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
              for h, w in SERVE_SHAPES]
    server.predict(images[:1])             # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()

    reset_launches()
    server.forward_batches = 0
    t0 = time.perf_counter()
    outs = server.predict(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    batches = server.forward_batches

    for im, out in zip(images, outs):
        check(out.shape == im.shape, f"output {out.shape} for {im.shape}")
        check(bool(np.isfinite(out).all()), f"non-finite output {im.shape}")
    check(batches == 4, f"expected 4 forward batches, ran {batches}")
    expect_launches(counts, f"{what} serving",
                    **{k: n * batches for k, n in per_forward.items()})
    used = {k: n for k, n in counts.items() if n}
    print(f"{what} serving: {len(images)} requests in {wall:.3f} s "
          f"({wall / len(images) * 1e3:.1f} ms/request), {batches} forward "
          f"batches, launches {used}")
    return {"launches": counts, "wall_s": wall, "server": server,
            "images": images, "outputs": outs}


def served_err(what: str, dt: torch.dtype, got, ref) -> float:
    """Served outputs against the same requests on a plain path: each
    within ``SERVE_TOL[dt] * max(1, max|ref|)``; returns the worst error."""
    tol, worst = SERVE_TOL[dt], 0.0
    for g, r in zip(got, ref):
        e = float(np.abs(g - r).max())
        scale = float(np.abs(r).max())
        print(f"served {what}, {str(dt)[6:]}, {r.shape[0]}x{r.shape[1]}: "
              f"max_abs={e:.3e} max|ref|={scale:.3e} tol={tol:.1e} * "
              f"max(1, max|ref|)")
        check(g.shape == r.shape and bool(np.isfinite(g).all())
              and e <= tol * max(1.0, scale),
              f"served {dt} {r.shape} output off the plain path ({what})")
        worst = max(worst, e)
    return worst


# the device kernels of K1 and K2 on the bf16 tensor-core route, and of
# the FMA route that a bf16 block of the main paths must not take
K12_TENSOR_CORES = ("nafblk::k1_front_kernel", "nafblk::k1_dw_kernel",
                    "nafblk::k2_mma_kernel")
K12_FMA = ("k1_kernel", "k2_kernel")


def expect_tensor_core_route(names, what: str, backward: bool = False,
                             fma_too: bool = False) -> None:
    """The bf16 NAFBlocks ran K1 and K2 (and with ``backward`` K3 and K4)
    on the tensor cores: every device kernel of that route is among
    ``names``, and none of the FMA route's -- or, with ``fma_too`` (a
    network whose narrow blocks take the FMA route), every one of those
    as well."""
    mma = K12_TENSOR_CORES + (K34_TENSOR_CORES if backward else ())
    fma = K12_FMA + (K34_FMA if backward else ())
    missing = [k for k in mma + (fma if fma_too else ()) if k not in names]
    wrong = [] if fma_too else [k for k in fma if k in names]
    check(not missing and not wrong, f"{what}: device kernels {missing} "
          f"missing, FMA kernels {wrong} ran")
    print(f"{what}: ran {', '.join(mma)}"
          + (f" and {', '.join(fma)}" if fma_too else
             f"; none of {', '.join(fma)}"))


def serving_phase(gen: torch.Generator) -> dict:
    from torch.profiler import ProfilerActivity, profile

    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda")
    check(len(net.blocks()) == 36, "NewBPNAFNet must hold 36 NAFBlocks")
    randomize_(net, gen, 0.1)
    res = serve_mix(net, "NewBPNAFNet", nafblk_a=36, nafblk_b=36)
    server, images = res.pop("server"), res.pop("images")
    del res["outputs"]
    # one served request under the profiler: the device kernels it ran
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        server.predict(images[:1])
        torch.cuda.synchronize()
    expect_tensor_core_route(device_records(prof.key_averages()),
                             "NewBPNAFNet served 512x512 request")

    # the same request on the model's plain (eager) path on the card
    probe = [images[SERVE_SHAPES.index((256, 384))]]
    eager = {}
    for dt in SERVE_TOL:
        net.dtype = dt
        fused = server.predict(probe)
        for b in net.blocks():
            b.fused = False
        plain = server.predict(probe)
        for b in net.blocks():
            b.fused = True
        eager[str(dt)[6:]] = served_err("NewBPNAFNet vs eager blocks", dt,
                                        fused, plain)
    return {**res, "eager_err": eager}


def recipe(config: Path, network_g: dict, res_scale: float,
           pool_impl: str = None, **hybrid):
    """``(net, loss, state, step)`` of ``config``'s train block around
    ``network_g`` (its ``network_g`` when None), on the card, with seeded
    random weights; ``pool_impl`` goes to ``hybrid_opt.perceptual``, the
    other keywords into ``hybrid_opt``."""
    opt = parse(str(config), is_train=True)
    train = copy.deepcopy(opt["train"])
    if pool_impl is not None:
        train["hybrid_opt"]["perceptual"] = {"pool_impl": pool_impl}
    if hybrid:
        train["hybrid_opt"].update(hybrid)
    amp = bool(train.get("enable_amp"))
    net = define_network({**(network_g or opt["network_g"]),
                          "dtype": "bfloat16" if amp else "float32"},
                         device="cuda")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED),
               res_scale)
    loss, pixel_loss = build_training_losses(train, device="cuda")
    optim = dict(train["optim_g"])
    base_lr = float(optim.pop("lr"))
    schedule = make_schedule(train["scheduler"], base_lr,
                             train.get("warmup_iter", -1))
    optimizer = make_optimizer(
        schedule, optim_type=optim.pop("type"),
        betas=tuple(optim.pop("betas")),
        weight_decay=float(optim.pop("weight_decay")),
        use_grad_clip=bool(train.get("use_grad_clip", True)),
        accum_steps=int(train.get("accum_steps", 1)))
    state = create_train_state(net, optimizer, loss)
    step = make_train_step(net, loss, optimizer, pixel_loss=pixel_loss)
    return net, loss, state, step


def flagship_batch(side: int = 384) -> dict:
    """One seeded synthetic batch of the flagship recipe's shape (2 x 384^2
    crops, or ``side``^2): uniform ``gt``, exposure ratios 100 and 300."""
    rng = np.random.default_rng(SEED)
    gt = rng.uniform(0, 1, (BATCH, 3, side, side)).astype(np.float32)
    expo = np.array([100.0, 300.0], np.float32)
    lq = np.clip(gt / expo[:, None, None, None]
                 + rng.normal(0, 1e-3, gt.shape), 0, 1).astype(np.float32)
    return {"lq": torch.from_numpy(lq).cuda(),
            "gt": torch.from_numpy(gt).cuda(),
            "expo_ratio": torch.from_numpy(expo).cuda()}


def run_steps(what: str, step, state, batch, steps: int = TRAIN_STEPS,
              **per_step: int) -> dict:
    """1 warm-up and ``steps`` timed steps: finite logs, ``per_step``
    launches in every step (every other kernel none), a falling loss."""
    state, logs0 = step(state, batch)             # warm-up
    assert_finite_logs(logs0)
    torch.cuda.synchronize()
    times, history, total = [], [], {k: 0 for k in WRAPPERS}
    first = state.step
    for _ in range(steps):
        reset_launches()
        t0 = time.perf_counter()
        state, logs = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = launches()
        assert_finite_logs(logs)
        history.append({k: float(v) for k, v in logs.items()})
        expect_launches(counts, f"{what} training step", **per_step)
        for k, n in counts.items():
            total[k] += n
    trace = traced_step(what, step, state, batch, statistics.median(times))
    l0, l1 = float(logs0["l_total"]), history[-1]["l_total"]
    print(f"{what} training: {steps} steps, ms/step median "
          f"{statistics.median(times):.1f} (all {[round(t, 1) for t in times]})"
          f", l_total {l0:.6f} -> {l1:.6f}, launches/step {per_step}")
    for i, h in enumerate(history):
        print(f"  step {first + i}: "
              + " ".join(f"{k}={v:.6g}" for k, v in h.items()))
    check(l1 < l0, f"{what}: l_total did not fall: {l0} -> {l1}")
    return {"ms_per_step": statistics.median(times), "step_ms": times,
            "l_total": [l0] + [h["l_total"] for h in history],
            "logs": history, "launches": total,
            "launches_per_step": per_step, **trace}


def traced_step(what: str, step, state, batch, untraced_ms: float) -> dict:
    """One more step under ``torch.profiler``: the device's busy time (the
    sum of every device kernel, copy and fill; one stream, so they do not
    overlap) and its idle share of the untraced median step. The profiler
    now and then loses a few kernel records, so a trace is held against
    the kernel launches that its host side shows, and an incomplete one is
    taken again. If ``PROFILER_TRIES`` traces all lack records, the fullest
    is reported as what it is: a lower bound of the busy time, with both
    counts beside it. Nothing is added for the lost records."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_SLACK_S)
            state, _ = step(state, batch)
            torch.cuda.synchronize()
        averages = prof.key_averages()
        records = device_records(averages)
        recorded = sum(n for k, (n, _) in records.items()
                       if not k.startswith("Mem"))
        launched = sum(ev.count for ev in averages if ev.key in LAUNCH_CALLS)
        if best is None or recorded - launched > best[1] - best[2]:
            best = (records, recorded, launched)
        if recorded == launched:
            break
    records, recorded, launched = best
    if not records or not launched:
        print(f"{what} traced step: the profiler shows no device time")
        return {"device_busy_ms": "not measured",
                "device_idle_share": "not measured", "device_top": {},
                "device_kernels": [], "kernel_records": [recorded, launched]}
    totals = {k: t / 1e3 for k, (_, t) in records.items()}
    busy = sum(totals.values())
    top = dict(sorted(totals.items(), key=lambda kv: -kv[1])[:12])
    note = "" if recorded == launched else " (a lower bound: records lost)"
    print(f"{what} traced step: device busy {busy:.1f} ms{note} of the "
          f"{untraced_ms:.1f} ms untraced median step (idle share "
          f"{1 - busy / untraced_ms:.2f}), {recorded} kernel records for "
          f"{launched} launches; top (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in top.items()))
    return {"device_busy_ms": busy,
            "device_idle_share": 1 - busy / untraced_ms, "device_top": top,
            "device_kernels": sorted(records),
            "kernel_records": [recorded, launched]}


def compare_grads(what: str, names, g_kernel, g_plain) -> float:
    """Each leaf against its own scale: |kernel - plain| <= 1e-3 * max|g|
    of that leaf (1e-30 only lets a leaf whose gradient is exactly 0 in
    both pass). Returns the worst leaf's share of its limit."""
    readings = []
    for k, gk, gp in zip(names, g_kernel, g_plain):
        gmax = gp.abs().max().item()
        d = (gk - gp).abs().max().item()
        readings.append((d / max(1e-3 * gmax, 1e-30), k, d, gmax))
    readings.sort(reverse=True)
    print(f"fp32 gradients, {what}: {len(names)} leaves, limit 1e-3 * "
          f"max|g_plain| per leaf; worst five:")
    for frac, k, d, gmax in readings[:5]:
        print(f"  {k}: max_abs={d:.3e} max|g_plain|={gmax:.3e} "
              f"({frac:.3e} of its limit)")
    smallest = min(readings, key=lambda r: r[3])
    print(f"  smallest max|g_plain|: {smallest[1]} {smallest[3]:.3e}")
    for frac, k, d, gmax in readings:
        check(frac <= 1.0, f"fp32 grad {k} ({what}): |kernel - plain| {d} > "
              f"1e-3 * {gmax}")
    return readings[0][0]


def set_dtype(net, loss, dt: torch.dtype) -> None:
    net.dtype = dt
    if loss.perceptual is not None:
        loss.perceptual.vgg.dtype = dt


def eval_forward(what: str, net, lq: torch.Tensor, shape,
                 **expected: int) -> None:
    reset_launches()
    out = make_eval_step(net)(lq)
    torch.cuda.synchronize()
    counts = launches()
    check(tuple(out.shape) == tuple(shape)
          and bool(torch.isfinite(out).all()), f"{what} eval forward: bad "
          f"output {tuple(out.shape)}")
    expect_launches(counts, f"{what} eval forward", **expected)


def training_phase() -> dict:
    net, loss, state, step = recipe(TRAIN_CONFIG, None, 0.01)
    check(len(net.blocks()) == 36, "NewBPNAFNet must hold 36 NAFBlocks")
    # residual scales 0.01: the blocks start near the identity that
    # NAFNet's zero init of beta/gamma gives, yet every kernel gradient is
    # nonzero (at 0.1 the first AdamW steps overshoot and the loss bumps)
    batch = flagship_batch()
    four = dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)
    res = run_steps("NewBPNAFNet", step, state, batch, **four)
    expect_tensor_core_route(res["device_kernels"], "NewBPNAFNet traced step",
                             backward=True)

    # fp32 gradients through the kernels vs the eager block path
    amp_dt = net.dtype
    set_dtype(net, loss, torch.float32)
    params = list(net.parameters())
    names = [k for k, _ in net.named_parameters()]

    def grads():
        out = net(batch["lq"])
        total, _ = loss(**hybrid_batch_kwargs(out, batch))
        return torch.autograd.grad(total, params)

    reset_launches()
    g_kernel = grads()
    check(ops.call_p1.launches == 36 and ops.call_p2.launches == 36,
          "fp32 check did not run the backward kernels")
    for b in net.blocks():
        b.fused = False
    g_eager = grads()
    for b in net.blocks():
        b.fused = True
    res["grad_check_worst"] = compare_grads(
        "K1-K4 vs eager NAFBlocks", names, g_kernel, g_eager)
    set_dtype(net, loss, amp_dt)

    eval_forward("NewBPNAFNet", net, batch["lq"], batch["lq"].shape,
                 nafblk_a=36, nafblk_b=36)
    return res


# the debug configuration: NewBPNAFNet at width 8 (blocks at C=8, 16, 32)
DEBUG_CONFIG = TRAIN_CONFIG.parent / "debug" / "sid_newbp_mono_debug.yml"
DEBUG_SIDE = 128


def debug_path() -> dict:
    """``network_g`` of the debug configuration under the flagship ``train``
    block in bf16: one step on a seeded 2x3x128^2 batch (one launch of each
    of K1-K4 per block: its C=8 blocks on the FMA route, the C=16 and C=32
    blocks on the tensor cores), finite logs, then one traced step that
    names both routes' device kernels."""
    import yaml

    with open(DEBUG_CONFIG) as fh:
        network_g = yaml.safe_load(fh)["network_g"]
    net, loss, state, step = recipe(TRAIN_CONFIG, network_g, 0.01)
    widths = sorted(b.conv1.in_channels for b in net.blocks())
    check(net.dtype == torch.bfloat16 and widths == [8, 8, 16, 16, 32],
          f"debug network in bf16 with blocks at C=8, 8, 16, 16, 32; got "
          f"{net.dtype}, {widths}")
    batch = flagship_batch(DEBUG_SIDE)
    per_step = {k: len(widths) for k in
                ("nafblk_a", "nafblk_b", "nafblk_p1", "nafblk_p2")}
    state, logs = step(state, batch)              # warm-up
    assert_finite_logs(logs)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, logs = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launches()
    assert_finite_logs(logs)
    expect_launches(counts, "debug network bf16 training step", **per_step)
    print(f"debug network bf16 training step ({BATCH}x3x{DEBUG_SIDE}^2): "
          f"{ms:.1f} ms, launches {per_step}, "
          + " ".join(f"{k}={float(v):.6g}" for k, v in logs.items()))
    trace = traced_step("debug network", step, state, batch, ms)
    if trace["device_kernels"]:
        expect_tensor_core_route(trace["device_kernels"],
                                 "debug network traced step", backward=True,
                                 fma_too=True)
    return {"launches": counts, "l_total": float(logs["l_total"]), **trace}


# path T: the training entry point (Trainer) on the flagship config
T_STEPS = 4
T_SAVE = 2


def synthetic_sid_root(root: Path) -> Path:
    """The SID configs' layout under ``root`` (``SID_assets/
    manifest_sid.json``, ``SID_pack/{train,val}_{short,long}.pack``) from
    the port's ``make_synthetic_sid_tree``: 4 train and 2 val pairs at
    512^2, ratios 100/250/300, shot and read noise, seeded."""
    from lowlight_image_enhancement_tpu_torch.data import (
        make_synthetic_sid_tree)

    return Path(make_synthetic_sid_tree(str(root), n_train=4, n_val=2,
                                        size=512, seed=SEED))


def state_tensors(state) -> list:
    opt = state.optimizer
    return [t.detach().clone() for t in
            list(opt.params) + list(opt.mu) + list(opt.nu)]


def instrument(trainer, what: str, per_step: dict, record: dict) -> None:
    """Wraps the Trainer's step (its launches, reset just before and read
    just after each step, must be ``per_step``; its host time ending in
    ``torch.cuda.synchronize()``; the last batch it took), its saves (the
    state tensors at each saved step) and its validation (results and wall
    time) into ``record``."""
    step, save, validate = trainer.step_fn, trainer._save, trainer.validate

    def timed_step(state, batch):
        reset_launches()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        record["step_ms"].append((time.perf_counter() - t0) * 1e3)
        record["batch"] = batch
        expect_launches(launches(), f"{what} step {out[0].step}", **per_step)
        return out

    def saving():
        save()
        record["saved"][trainer.state.step] = state_tensors(trainer.state)

    def validating():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = validate()
        record["val"].append((res, time.perf_counter() - t0))
        return res

    trainer.step_fn, trainer._save, trainer.validate = (timed_step, saving,
                                                        validating)


def trainer_path(train_ms: float) -> dict:
    """Path T: ``Trainer(opt).train()`` on the card, ``opt`` the flagship
    config parsed over a synthetic SID tree, overridden only in
    ``train.total_iter`` 6, ``logger.print_freq`` 1,
    ``logger.save_checkpoint_freq`` 3, ``val.val_freq`` 6,
    ``use_tb_logger`` false and the experiment root. Checks the native
    pack reader, 36 launches of each of K1-K4 per step and their
    tensor-core kernels in a traced step, finite logs, the checkpoints at 3
    and 4, the four metrics of the validation at 4 (finite, 2 images of
    512^2), the restore of step 2 bit for bit, and a second Trainer that
    resumes at 2 with the schedule's step and reaches 4."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from lowlight_image_enhancement_tpu_torch.training import (
        checkpoint as ckpt)
    from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_t_"))
    t0 = time.perf_counter()
    os.environ["SID_ROOT"] = str(synthetic_sid_root(tmp / "sid"))
    t_data = time.perf_counter() - t0
    opt = parse(str(TRAIN_CONFIG), is_train=True, root_dir=str(tmp / "exp"))
    opt["train"]["total_iter"] = T_STEPS
    opt["logger"].update(print_freq=1, save_checkpoint_freq=T_SAVE,
                         use_tb_logger=False)
    opt["val"]["val_freq"] = T_STEPS
    four = dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)

    trainer = Trainer(opt)
    check(trainer.net.dtype == torch.bfloat16 and len(trainer.net.blocks())
          == 36, "path T: NewBPNAFNet in bf16 with 36 NAFBlocks")
    ds = trainer.train_loader.dataset
    check(ds._short.uses_native and ds._long.uses_native,
          "path T: the packs must be read by the native reader")
    rec = {"step_ms": [], "saved": {}, "val": []}
    instrument(trainer, "path T", four, rec)
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    hist = trainer.history
    check([h["iter"] for h in hist] == list(range(1, T_STEPS + 1))
          and all(np.isfinite(list(h.values())).all() for h in hist),
          f"path T: logs of iterations {[h['iter'] for h in hist]}")
    states, models = opt["path"]["training_states"], opt["path"]["models"]
    check(sorted(os.listdir(states)) == [f"{T_SAVE:08d}.pth",
                                         f"{T_STEPS:08d}.pth"]
          and {f"net_g_{T_SAVE:08d}.pth", f"net_g_{T_STEPS:08d}.pth",
               "net_g_latest.pth"} <= set(os.listdir(models)),
          f"path T: checkpoints {sorted(os.listdir(states))}")
    metrics = list(opt["val"]["metrics"])
    check(len(rec["val"]) == 2 and len(trainer.val_loader) == 2,
          f"path T: validation at {T_STEPS} and the final one, on 2 "
          f"images")
    for res, _ in rec["val"]:
        check(sorted(res) == sorted(metrics)
              and all(np.isfinite(v) for v in res.values()),
              f"path T: validation {res}")

    # the state of step T_SAVE comes back from its file bit for bit, and a
    # second Trainer resumes there and reaches T_STEPS
    os.remove(os.path.join(states, f"{T_STEPS:08d}.pth"))
    trainer2 = Trainer(opt)
    check(trainer2.start_iter == T_SAVE and trainer2.state.step == T_SAVE
          and trainer2.state.optimizer.count == T_SAVE,
          f"path T: resumed at {trainer2.start_iter}, count "
          f"{trainer2.state.optimizer.count}")
    restored = state_tensors(trainer2.state)
    check(len(restored) == len(rec["saved"][T_SAVE]) and all(
        torch.equal(a, b) for a, b in zip(restored, rec["saved"][T_SAVE])),
        f"path T: restore of step {T_SAVE} differs from what was saved")
    lr = trainer2.schedule(trainer2.state.optimizer.count)
    check(lr == trainer.schedule(T_SAVE),
          f"path T: resumed lr {lr} != schedule({T_SAVE})")
    rec2 = {"step_ms": [], "saved": {}, "val": []}
    instrument(trainer2, "path T resumed", four, rec2)
    step2 = trainer2.step_fn
    traced = {}

    def traced_first(state, batch):
        if traced:
            return step2(state, batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = step2(state, batch)
        traced.update(device_records(prof.key_averages()))
        return out

    trainer2.step_fn = traced_first
    trainer2.train()
    torch.cuda.synchronize()
    check([h["iter"] for h in trainer2.history]
          == list(range(T_SAVE + 1, T_STEPS + 1))
          and trainer2.state.step == T_STEPS,
          f"path T resumed: iterations {[h['iter'] for h in trainer2.history]}")
    expect_tensor_core_route(traced, f"path T traced step (resumed, "
                             f"iteration {T_SAVE + 1})", backward=True)

    ms = statistics.median(rec["step_ms"][1:])
    data_ms = statistics.median(h["data_time"] * 1e3 for h in hist[1:])
    iter_ms = statistics.median((h["time"] + h["data_time"]) * 1e3
                                for h in hist[1:])
    val_res, val_s = rec["val"][0]
    out = {"ms_per_step": ms, "step_ms": rec["step_ms"],
           "data_ms_per_step": data_ms, "iteration_ms": iter_ms,
           "data_ms": [h["data_time"] * 1e3 for h in hist],
           "val_wall_s": val_s, "val_metrics": val_res,
           "final_val_wall_s": rec["val"][1][1],
           "train_phase_ms_per_step": train_ms, "l_total":
           [h["l_total"] for h in hist], "resumed_l_total":
           [h["l_total"] for h in trainer2.history],
           "launches_per_step": four, "wall_s": t_train,
           "synthetic_data_s": t_data,
           "native_reader": bool(ds._short.uses_native)}
    print(f"path T: {T_STEPS} iterations in {t_train:.1f} s; step ms median "
          f"of 2-{T_STEPS} {ms:.1f} (all {[round(t, 1) for t in rec['step_ms']]})"
          f", data ms median {data_ms:.2f}, validation {val_s:.2f} s "
          f"{val_res}; training phase {train_ms:.1f} ms/step")
    print(json.dumps({"path_T": out}))
    os.environ.pop("SID_ROOT")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# path A: the remaining SID architectures through the Trainer, each config
# unchanged but for the iteration count, the logging / checkpoint /
# validation frequencies and the experiment root
A_STEPS = 4
A_CONFIGS = (
    # (config, $LLIE_MAXPOOL_IMPL for its run, launches per step)
    ("sid_nafnet_tpu.yml", None,
     dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)),
    # 3 UNet downs + the 4 pools of the perceptual term's VGG19 trunk
    ("sid_unet.yml", "kernel_bwd", dict(pool_bwd=7)),
    ("sid_swinir.yml", None, {}),
)


def random_vgg19_npz(path: Path) -> Path:
    """A seeded random VGG19 trunk in the ``.npz`` format of
    ``tools/convert_vgg_weights.py``: the configs that ask for the
    perceptual term without ``pretrained: false`` load it through
    ``$LLIE_VGG19_NPZ`` (the ImageNet weights are not in the
    repository)."""
    from lowlight_image_enhancement_tpu_torch.models.vgg import (
        VGG19Features, _random_init_)

    vgg = VGG19Features()
    _random_init_(vgg, torch.Generator().manual_seed(SEED))
    np.savez(path, **{k: v.numpy() for k, v in vgg.state_dict().items()})
    return path


def config_trainer_run(cfg: Path, exp_root: Path, what: str, steps: int,
                       per_step: dict) -> tuple:
    """``Trainer(opt).train()`` of ``cfg`` for ``steps`` iterations with a
    print every iteration, a checkpoint and a validation at the last, and
    ``per_step`` launches in every step; then one traced step. Checks the
    logs, the checkpoint files and the validation (the config's metrics,
    finite, at ``steps`` and the final one). Returns ``(trainer, opt,
    summary)``."""
    import os

    from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer

    opt = parse(str(cfg), is_train=True, root_dir=str(exp_root))
    opt["train"]["total_iter"] = steps
    opt["logger"].update(print_freq=1, save_checkpoint_freq=steps,
                         use_tb_logger=False)
    opt["val"]["val_freq"] = steps
    trainer = Trainer(opt)
    step = trainer.step_fn
    rec = {"step_ms": [], "saved": {}, "val": []}
    instrument(trainer, what, per_step, rec)
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist = trainer.history
    check([h["iter"] for h in hist] == list(range(1, steps + 1))
          and all(np.isfinite(list(h.values())).all() for h in hist),
          f"{what}: logs of iterations {[h['iter'] for h in hist]}")
    states, models = opt["path"]["training_states"], opt["path"]["models"]
    check(sorted(os.listdir(states)) == [f"{steps:08d}.pth"]
          and "net_g_latest.pth" in os.listdir(models),
          f"{what}: checkpoints {sorted(os.listdir(states))}")
    metrics = sorted(opt["val"]["metrics"])
    check(len(rec["val"]) == 2 and all(
        sorted(res) == metrics and all(np.isfinite(v) for v in res.values())
        for res, _ in rec["val"]), f"{what}: validation {rec['val']}")
    ms = statistics.median(rec["step_ms"][1:])
    trace = traced_step(what, step, trainer.state, rec["batch"], ms)
    out = {"ms_per_step": ms, "step_ms": rec["step_ms"],
           "data_ms_per_step": statistics.median(
               h["data_time"] * 1e3 for h in hist[1:]),
           "l_total": [h["l_total"] for h in hist],
           "val_metrics": rec["val"][0][0], "val_wall_s": rec["val"][0][1],
           "launches_per_step": per_step, "wall_s": wall,
           **{k: trace[k] for k in ("device_busy_ms", "device_idle_share",
                                     "device_kernels", "kernel_records")}}
    print(f"{what}: {steps} iterations in {wall:.1f} s; step ms median of "
          f"2-{steps} {ms:.1f} (all {[round(t, 1) for t in rec['step_ms']]})"
          f", data ms median {out['data_ms_per_step']:.2f}, validation "
          f"{out['val_wall_s']:.2f} s {out['val_metrics']}")
    return trainer, opt, out


def run_test_cli(opt: dict, latest: Path, work: Path, what: str) -> dict:
    """``test.py`` (its ``main``, on the card) on ``latest`` through a copy
    of the run's config with ``path.pretrain_network_g`` set: the config's
    metrics, finite, on the validation split."""
    import yaml

    from lowlight_image_enhancement_tpu_torch import test as test_cli

    cfg = {k: v for k, v in copy.deepcopy(opt).items() if k != "is_train"}
    cfg["path"] = {"pretrain_network_g": str(latest)}
    with open(work / "eval.yml", "w") as fh:
        yaml.safe_dump(cfg, fh)
    results = test_cli.main(["-opt", str(work / "eval.yml")])
    name = opt["datasets"]["val"]["name"]
    check(list(results) == [name] and sorted(results[name]) == sorted(
        opt["val"]["metrics"]) and all(np.isfinite(v) for v in
                                       results[name].values()),
          f"{what}: test.py results {results}")
    print(f"{what} test.py on net_g_latest.pth: {results[name]}")
    return results[name]


def architectures_path(path_t_ms: float) -> dict:
    """Path A: ``Trainer(opt).train()`` on ``configs/sid_nafnet_tpu.yml``
    (bf16, 384^2 crops), ``sid_unet.yml`` (bf16, 384^2, its run under
    ``LLIE_MAXPOOL_IMPL=kernel_bwd``) and ``sid_swinir.yml`` (bf16, 256^2)
    at full width and depth over a synthetic SID tree (as path T's), for
    ``A_STEPS`` iterations each: the launches per step of ``A_CONFIGS``
    (NAFNetTPU's K1-K4 on the tensor cores by the device kernels of a
    traced step, UNet's K8 named there too), finite logs, a checkpoint,
    the validation with each config's metrics, then ``test.py`` on the
    saved ``net_g_latest.pth``."""
    import os
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_a_"))
    os.environ["SID_ROOT"] = str(synthetic_sid_root(tmp / "sid"))
    os.environ["LLIE_VGG19_NPZ"] = str(random_vgg19_npz(tmp / "vgg19.npz"))
    out = {}
    try:
        for name, pool_impl, per_step in A_CONFIGS:
            what = f"path A {name}"
            if pool_impl:
                os.environ["LLIE_MAXPOOL_IMPL"] = pool_impl
            try:
                trainer, opt, res = config_trainer_run(
                    TRAIN_CONFIG.with_name(name), tmp / "exp", what, A_STEPS,
                    per_step)
            finally:
                os.environ.pop("LLIE_MAXPOOL_IMPL", None)
            check(trainer.net.dtype == torch.bfloat16,
                  f"{what}: the network must train in bf16")
            names = res["device_kernels"]
            if name == "sid_nafnet_tpu.yml":
                widths = [b.conv1.in_channels for b in trainer.net.blocks()]
                res["blocks_per_width"] = {c: widths.count(c)
                                           for c in sorted(set(widths))}
                check(len(widths) == 36 and sorted(set(widths))
                      == [64, 128, 256, 512, 1024],
                      f"{what}: 36 NAFBlocks at C = 64 ... 1024")
                expect_tensor_core_route(names, f"{what} traced step",
                                         backward=True)
            if name == "sid_unet.yml":
                check("pool_bwd_kernel" in names,
                      f"{what}: K8's device kernel missing from the trace")
            res["test"] = run_test_cli(
                opt, Path(opt["path"]["models"]) / "net_g_latest.pth", tmp,
                what)
            res["path_T_ms_per_step"] = path_t_ms
            out[name.split(".")[0]] = res
            print(f"{what}: {res['ms_per_step']:.1f} ms/step, data "
                  f"{res['data_ms_per_step']:.2f} ms/step, device busy "
                  f"{fmt_device(res['device_busy_ms'])}, idle share "
                  f"{res['device_idle_share']}; path T "
                  f"{path_t_ms:.1f} ms/step")
            del trainer
    finally:
        os.environ.pop("SID_ROOT", None)
        os.environ.pop("LLIE_VGG19_NPZ", None)
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"path_A": {k: {kk: v[kk] for kk in (
        "ms_per_step", "data_ms_per_step", "device_busy_ms",
        "device_idle_share", "val_metrics", "test", "launches_per_step")}
        for k, v in out.items()}}))
    return out


def tlc_path(gen: torch.Generator) -> dict:
    """Path C: ``NAFNetLocal`` (TLC) at NAFNet's SID configuration (width
    32, enc (2,2,4,8), 12 middle, dec (2,2,2,2)) in bf16 with seeded random
    weights, on a 1x3x512^2 request through the eval forward: with a window
    >= 2x the image (train_size 1024 -> 1536) it must equal the fused
    ``NAFNet`` of the same weights (36 K1/K2 launches) within the served
    bf16 bar, with no launch of K1-K4 (TLC blocks run the module graph, as
    in JAX); at the recipe's window (train_size 256 -> 384) the output is
    finite, again with no launch."""
    base = {"width": 32, "enc_blk_nums": [2, 2, 4, 8], "middle_blk_num": 12,
            "dec_blk_nums": [2, 2, 2, 2], "dtype": "bfloat16"}
    fused = define_network({"type": "NAFNet", **base}, device="cuda")
    randomize_(fused, gen, 0.1)
    nets = {"fused": fused}
    for what, side in (("global", 1024), ("local", 256)):
        net = define_network({"type": "NAFNetLocal",
                              "train_size": [side, side], **base},
                             device="cuda")
        net.load_state_dict(fused.state_dict())
        nets[what] = net
    check(nets["local"].blocks()[0].tlc_window == (384, 384),
          "NAFNetLocal(train_size 256) must window at 384")
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0, 1, (1, 3, 512, 512)).astype(np.float32)).cuda()
    outs, counts, ms = {}, {}, {}
    for what, net in nets.items():
        forward = make_eval_step(net)
        forward(x)                                   # warm-up
        reset_launches()
        outs[what] = forward(x)
        torch.cuda.synchronize()
        counts[what] = launches()
        check(tuple(outs[what].shape) == (1, 3, 512, 512)
              and bool(torch.isfinite(outs[what]).all()),
              f"path C {what}: bad output")
        ms[what] = time_ms(lambda: forward(x), iters=5)
    expect_launches(counts["fused"], "path C fused NAFNet", nafblk_a=36,
                    nafblk_b=36)
    expect_launches(counts["global"], "path C NAFNetLocal window 1536")
    expect_launches(counts["local"], "path C NAFNetLocal window 384")
    hwc = lambda t: t[0].permute(1, 2, 0).cpu().numpy()
    e = served_err("NAFNetLocal window >= 2x image vs fused NAFNet",
                   torch.bfloat16, [hwc(outs["global"])], [hwc(outs["fused"])])
    diff = float((outs["local"] - outs["global"]).abs().max())
    out = {"err_vs_fused": e, "local_vs_global_max_abs": diff,
           "forward_ms": ms, "launches": counts}
    print(f"path C: forward ms {ms}; window 384 vs global mean: max_abs "
          f"{diff:.3e}")
    print(json.dumps({"path_C": {k: out[k] for k in (
        "err_vs_fused", "local_vs_global_max_abs", "forward_ms")}}))
    return out


def stereo_trainer_path() -> dict:
    """Path R: ``Trainer(opt).train()`` on ``configs/stereo_nafssr.yml``
    unchanged (width 48, 16 blocks, drop-path 0.1, batches of 16 60x180 HR
    crops, fp32) with ``STEREO_ROOT`` at a synthetic stereo tree
    (``make_synthetic_stereo``: 16 train and 2 val samples), 4 iterations:
    32 launches of each of K1-K6 per step, finite logs, the PSNR of the
    validation; then ``LowlightModel`` (the config's ``model_type``) for 2
    ``optimize_parameters`` steps on the same loader and ``test()``
    ([N, 6, 2H, 2W]); then ``demo_ssr`` in a subprocess on one L/R pair
    with the trained weights (two PNGs at 2x)."""
    import os
    import tempfile

    from lowlight_image_enhancement_tpu_torch.data import (
        epochs, make_synthetic_stereo)
    from lowlight_image_enhancement_tpu_torch.training.model_wrapper import (
        create_model)
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_r_"))
    t0 = time.perf_counter()
    tree = make_synthetic_stereo(str(tmp / "stereo"), seed=SEED)
    t_data = time.perf_counter() - t0
    # the views' rows cycle through PNG filters 0-4; every one must be
    # defiltered by native/pngcodec.cpp, none by the Python fallback
    check(imgio.uses_native_defilter(), "path R: the native PNG defilter "
          "did not load")
    imgio.defilter.native = imgio.defilter.python = 0
    os.environ["STEREO_ROOT"] = tree["root"]
    per_step = dict(nafblk_a=32, nafblk_b=32, nafblk_p1=32, nafblk_p2=32,
                    ln_fwd=32, ln_bwd=32)
    try:
        trainer, opt, res = config_trainer_run(
            STEREO_CONFIG, tmp / "exp", "path R", A_STEPS, per_step)
        defilter = {"native": imgio.defilter.native,
                    "python": imgio.defilter.python}
        check(defilter["native"] > 0 and defilter["python"] == 0,
              f"path R: PNG views defiltered {defilter}")
        res["defilter"] = defilter
        print(f"path R: PNG views defiltered {defilter}; data ms/step "
              f"{res['data_ms_per_step']:.2f} (167.3 over filter-0 views "
              f"with the Python defilter, PR 10)")
        net = trainer.net
        check(len(net.blocks()) == 16 and net.blocks()[0].conv1.in_channels
              == 48 and all(b.drop_path.rate == 0.1 for b in net.body)
              and net.dtype == torch.float32
              and net.generator.device.type == "cuda",
              "path R: NAFSSR must be the config's network, its drop-path "
              "drawn from a generator on the card")

        model = create_model(opt)
        check(type(model).__name__ == "LowlightModel",
              "path R: the config's model_type is LowlightModel")
        stream = epochs(trainer.train_loader)
        logs = []
        for _ in range(2):
            model.feed_data(next(stream))
            reset_launches()
            model.optimize_parameters()
            torch.cuda.synchronize()
            expect_launches(launches(), "path R LowlightModel step",
                            **per_step)
            logs.append(model.get_current_log())
            check(np.isfinite(logs[-1]["l_total"]),
                  f"path R LowlightModel: {logs[-1]}")
        model.test()
        n, _, h, w = model.batch["lq"].shape
        check(tuple(model.output.shape) == (n, 6, 2 * h, 2 * w),
              f"path R LowlightModel test(): {tuple(model.output.shape)}")
        res["wrapper_logs"] = logs

        sample = Path(tree["val_lr"]) / "0001"
        outs = [tmp / "out_l.png", tmp / "out_r.png"]
        root = Path(__file__).resolve().parent
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "lowlight_image_enhancement_tpu_torch.demo_ssr", "-opt",
             str(STEREO_CONFIG), "--input_l_path", str(sample / "lr0.png"),
             "--input_r_path", str(sample / "lr1.png"),
             "--output_l_path", str(outs[0]), "--output_r_path",
             str(outs[1]), "--weights",
             str(Path(opt["path"]["models"]) / "net_g_latest.pth")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0,
              f"demo_ssr failed:\n{(proc.stdout + proc.stderr)[-3000:]}")
        lr = imgio.imread(str(sample / "lr0.png"))
        for path in outs:
            img = imgio.imread(str(path))
            check(img.shape == (2 * lr.shape[0], 2 * lr.shape[1], 3)
                  and img.dtype == np.uint8, f"demo_ssr {path.name}: "
                  f"{img.shape} for an input of {lr.shape}")
        print(f"path R demo_ssr: rc 0 in {time.perf_counter() - t0:.1f} s, "
              f"{lr.shape[:2]} -> {img.shape[:2]} per view")
    finally:
        os.environ.pop("STEREO_ROOT", None)
        shutil.rmtree(tmp, ignore_errors=True)
    res["synthetic_data_s"] = t_data
    print(json.dumps({"path_R": {k: res[k] for k in (
        "ms_per_step", "data_ms_per_step", "device_busy_ms",
        "device_idle_share", "val_metrics", "launches_per_step",
        "defilter")}}))
    return res


# path E: the serving buckets of the exported NewBPNAFNet (one the size of
# the mix's 256x384 request, one 512x512 for larger ones)
EXPORT_BUCKETS = ((256, 384), (512, 512))
K1_OP, K2_OP, K5_OP = ("llie_torch.nafblock_a.default",
                       "llie_torch.nafblock_b.default",
                       "llie_torch.ln_fwd.default")


def op_nodes(path: Path) -> dict:
    """Nodes of each registered kernel op in the saved program."""
    program = torch.export.load(str(path))
    nodes = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return {k: nodes.count(k) for k in (K1_OP, K2_OP, K5_OP)}


def exported_vs_live(what: str, got: np.ndarray, ref: np.ndarray) -> float:
    """An exported output against the live model's on the same padded
    input: equal bits expected; else within 2^-6 of max|ref| (the bf16
    bar of the kernel checks). Returns max|got - ref|."""
    e = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    inside = float(((ref > 0) & (ref < 1)).mean())
    print(f"{what}: exported vs live max_abs={e:.3e} (equal bits: "
          f"{e == 0.0}) max|ref|={scale:.3e}, {inside:.3f} of the outputs "
          f"inside (0, 1)")
    check(got.shape == ref.shape and bool(np.isfinite(got).all())
          and e <= TOL[torch.bfloat16] * scale,
          f"{what}: exported output off the live model's")
    return e


def export_run(net, what: str, buckets, requests, **per_forward: int):
    """``export_model`` of ``net`` into a temporary directory, then a
    fresh ``ExportedModel`` of it: graph nodes, launches per forward on
    the tensor-core route, exported against live on every request (padded
    as the loader pads), ``predict_batch``, ms per request exported and
    live. Returns ``(summary, model, directory, live)``."""
    import tempfile

    from lowlight_image_enhancement_tpu_torch.export import (
        ClippedForward, ExportedModel, export_model, net_state)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_e_"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_model(net, str(tmp), buckets=buckets, batch=1, device="cuda")
    export_s = time.perf_counter() - t0
    sizes = {f.name: f.stat().st_size for f in sorted(tmp.iterdir())}
    want_nodes = {K1_OP: per_forward.get("nafblk_a", 0),
                  K2_OP: per_forward.get("nafblk_b", 0),
                  K5_OP: per_forward.get("ln_fwd", 0)}
    for name in sizes:
        if name.endswith(".pt2"):
            nodes = op_nodes(tmp / name)
            check(nodes == want_nodes, f"{what} {name}: op nodes {nodes}, "
                  f"expected {want_nodes}")
    print(f"{what}: export {export_s:.1f} s, files {sizes}, op nodes per "
          f"program {want_nodes}")

    t0 = time.perf_counter()
    model = ExportedModel(str(tmp))
    load_s = time.perf_counter() - t0
    state = net_state(net)
    forward = ClippedForward(net)

    def live(img):
        """The live model on the input ``predict`` hands its program."""
        h, w = img.shape[:2]
        bh, bw = model._pick_bucket(h, w)
        x = np.zeros((1, bh, bw, 3), np.float32)
        x[0, :h, :w] = img
        with torch.no_grad():
            y = forward(state, torch.from_numpy(x).cuda())
        return y.cpu().numpy()[0, :h, :w]

    for img in requests:
        model.predict(img)                 # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()
    errs, outs = {}, []
    for img in requests:
        reset_launches()
        got = model.predict(img)
        torch.cuda.synchronize()
        expect_launches(launches(), f"{what} {img.shape[:2]} request",
                        **per_forward)
        outs.append(got)
        errs[f"{img.shape[0]}x{img.shape[1]}"] = exported_vs_live(
            f"{what} {img.shape[0]}x{img.shape[1]}", got, live(img))
    reset_launches()
    batch_outs = model.predict_batch(requests)
    torch.cuda.synchronize()
    expect_launches(launches(), f"{what} predict_batch",
                    **{k: n * len(requests) for k, n in per_forward.items()})
    for a, b in zip(batch_outs, outs):
        check(a.shape == b.shape and np.array_equal(a, b),
              f"{what}: predict_batch differs from predict")
    ms = {"exported": wall_ms_median(lambda: model.predict(requests[0])),
          "live": wall_ms_median(lambda: live(requests[0]))}
    print(f"{what}: ExportedModel load {load_s:.1f} s; "
          f"{requests[0].shape[0]}x{requests[0].shape[1]} request ms "
          f"exported {ms['exported']:.2f}, live {ms['live']:.2f}")
    res = {"export_s": export_s, "load_s": load_s, "file_bytes": sizes,
           "op_nodes_per_program": {k.split(".")[1]: v
                                    for k, v in want_nodes.items()},
           "launches_per_forward": per_forward, "exported_vs_live": errs,
           "ms_per_request": ms}
    return res, model, tmp, live


def wall_ms_median(fn, iters: int = 5) -> float:
    """Median host-clock ms of ``fn()`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def export_path() -> dict:
    """Path E, the slice's main path: ``export_model`` of ``NewBPNAFNet``
    at the serving configuration (width 32, enc (2,2,4,8), 12 middle, dec
    (2,2,2,2), bf16, seeded weights, residual scales 0.1) at buckets
    256x384 and 512x512, then a fresh ``ExportedModel`` serving a 256x384
    and a 500x500 request and ``predict_batch`` over both: 36 K1 and 36 K2
    op nodes in each program, 36 launches of each per forward on the
    tensor-core route, the exported output against the live model's, and
    a ``params.npz`` swapped for re-seeded weights giving the live
    model's output with those weights. Its weights come from a generator
    of its own, so the paths after it draw what they drew before."""
    from torch.profiler import ProfilerActivity, profile

    from lowlight_image_enhancement_tpu_torch.export import (
        ExportedModel, flatten_params, net_state)

    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda").eval()
    check(len(net.blocks()) == 36, "NewBPNAFNet must hold 36 NAFBlocks")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED + 11),
               0.1)
    rng = np.random.default_rng(SEED)
    requests = [rng.uniform(0, 1, shape + (3,)).astype(np.float32)
                for shape in ((256, 384), (500, 500))]
    res, model, tmp, live = export_run(net, "path E", EXPORT_BUCKETS,
                                       requests, nafblk_a=36, nafblk_b=36)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.predict(requests[0])
            torch.cuda.synchronize()
        expect_tensor_core_route(device_records(prof.key_averages()),
                                 "path E exported 256x384 request")
        before = model.predict(requests[0])
        randomize_(net, torch.Generator(device="cuda").manual_seed(SEED + 1),
                   0.1)
        np.savez(tmp / "params.npz", **flatten_params(
            {k: v.cpu().numpy() for k, v in net_state(net).items()}))
        swapped = ExportedModel(str(tmp)).predict(requests[0])
        moved = float(np.abs(swapped - before).max())
        check(moved > 0.0, "path E: the swapped params.npz left the output "
              "unchanged")
        res["swap"] = {"moved_max_abs": moved,
                       "exported_vs_live": exported_vs_live(
                           "path E, re-seeded params.npz", swapped,
                           live(requests[0]))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"path_E": res}))
    return res


def baseline_export_path() -> dict:
    """``Baseline`` at path B's width-32 configuration (bf16, seeded
    weights, residual scales 0.1) exported at one 256x384 bucket and
    served by a fresh ``ExportedModel``: 72 K5 op nodes, 72 launches per
    forward, the exported output against the live model's (weights from a
    generator of its own)."""
    net = define_network({**BASELINE_W32, "dtype": "bfloat16"},
                         device="cuda").eval()
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED + 12),
               0.1)
    img = np.random.default_rng(SEED + 2).uniform(
        0, 1, (256, 384, 3)).astype(np.float32)
    res, _, tmp, _ = export_run(net, "Baseline export", EXPORT_BUCKETS[:1],
                                [img], ln_fwd=72)
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"path_B_export": res}))
    return res


def flow_device_check() -> dict:
    """``flow_warp`` at 1x256x256x64 and ``duf_downsample`` of one 7-frame
    3x256x256 clip on the card against the same calls on the CPU (fp32,
    1e-5 of max|ref|). No kernel: a check that the video path runs on the
    device."""
    from lowlight_image_enhancement_tpu_torch.data import duf_downsample
    from lowlight_image_enhancement_tpu_torch.ops.image_ops import flow_warp

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((1, 256, 256, 64)).astype(
        np.float32))
    flow = torch.from_numpy(rng.uniform(-8, 8, (1, 256, 256, 2)).astype(
        np.float32))
    clip = torch.from_numpy(rng.uniform(0, 1, (7, 256, 256, 3)).astype(
        np.float32))
    out = {}
    calls = {f"flow_warp_{m}_{p}": (lambda t, m=m, p=p: flow_warp(
                 t[0], t[1], m, p), (x, flow))
             for m, p in (("bilinear", "zeros"), ("nearest", "border"))}
    calls["duf_downsample_x4"] = (lambda t: duf_downsample(t[0], scale=4),
                                  (clip,))
    for name, (fn, args) in calls.items():
        ref = fn(args)
        got = fn(tuple(a.cuda() for a in args))
        check(got.is_cuda, f"{name} left the card")
        e, rel = err(got.cpu(), ref)
        print(f"{name} card vs CPU: shape {tuple(got.shape)}, max_abs "
              f"{e:.3e} ({rel:.3e} of max|ref|)")
        check(rel <= 1e-5, f"{name}: card off the CPU")
        out[name] = e
    return out


# path M: the evaluation metrics; the slice's cut of a SID Sony frame
# (2848x4256): a quarter of its pixels, 1424x2128, so that the fp32 VGG16
# activations of both LPIPS images stay well inside 80 GB
SID_QUARTER = (1424, 2128)


def nafnet_macs(width: int, enc, mid: int, dec, h: int, w: int,
                c_in: int = 3) -> int:
    """Multiply-adds of NAFNet's convolutions and products at (h, w):
    intro, per block conv1 (C -> 2C), the 3x3 depthwise conv, conv3,
    conv4 (C -> 2C), conv5 and the SCA 1x1, the 2x2 down and 1x1 up convs,
    ending."""
    macs, c = 9 * c_in * width * h * w, width

    def block(c, hw):
        return hw * (2 * c * c + 18 * c + c * c + 2 * c * c + c * c) + c * c

    for n in enc:
        macs += n * block(c, h * w)
        h, w = h // 2, w // 2
        macs += 4 * c * 2 * c * h * w
        c *= 2
    macs += mid * block(c, h * w)
    for n in dec:
        macs += c * 2 * c * h * w
        h, w, c = h * 2, w * 2, c // 2
        macs += n * block(c, h * w)
    return macs + 9 * c * c_in * h * w


def wall_ms(fn) -> float:
    """Host ms of one call of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def evaluation_path() -> dict:
    """Path M: the flagship ``NewBPNAFNet`` at full width and depth (bf16,
    seeded as the serving phase's: residual scales 0.1) through
    ``metrics.compute_metrics`` over the two 512^2 validation pairs of
    path T's synthetic SID tree (``SonySIDDataset``: ``short_raw`` and
    ``expo_ratio``), with the P2 raw PSF, LPIPS-vgg and the sRGB
    conversion. Checks every key finite (``lpips`` and ``phys_mae``
    among them), 36 launches of K1 and K2 per forward, LPIPS alex and vgg
    and InceptionV3 pool3 on the card against the same modules on the CPU,
    the VGG19 FID features under ``kernel_fused`` (4 K7 launches a call)
    against ``reduce_window``, NIQE finite, and ``count_flops`` of the
    forward at 1x3x512^2 equal to its analytic MAC count; times each
    metric, LPIPS-vgg per 512^2 pair, Inception per 299^2 batch, the
    forward by ``measure_inference_time`` and one LPIPS-vgg pair and one
    Inception call at 1424x2128."""
    import os
    import tempfile

    from lowlight_image_enhancement_tpu_torch import metrics as M
    from lowlight_image_enhancement_tpu_torch.data import (
        create_dataset, create_loader)
    from lowlight_image_enhancement_tpu_torch.ops.color import linear_to_srgb
    from lowlight_image_enhancement_tpu_torch.ops.psf import (
        build_psf_kernels, normalize_psf_energy)

    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED), 0.1)
    eval_step = make_eval_step(net)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_m_"))
    os.environ["SID_ROOT"] = str(synthetic_sid_root(tmp / "sid"))
    opt = parse(str(TRAIN_CONFIG), is_train=False)
    val_opt = opt["datasets"]["val"]
    loader = create_loader(create_dataset(val_opt), val_opt, seed=SEED)
    batches = list(loader)
    check(len(batches) == 2 and all(
        b["lq"].shape == (1, 512, 512, 3) and "short_raw" in b
        and "expo_ratio" in b for b in batches),
        "path M: the two 512^2 validation pairs with short_raw, expo_ratio")
    psf = normalize_psf_energy(build_psf_kernels("mono", "P2"))
    outputs = []

    def forward(x):
        out = eval_step(x)
        outputs.append(out.float())
        return out

    reset_launches()
    t0 = time.perf_counter()
    res = M.compute_metrics(forward, batches, psf_kernel=psf, use_lpips=True,
                            lpips_net="vgg", srgb_convert=True,
                            device="cuda")
    torch.cuda.synchronize()
    t_metrics = time.perf_counter() - t0
    expect_launches(launches(), "path M compute_metrics",
                    nafblk_a=36 * len(outputs), nafblk_b=36 * len(outputs))
    check(len(outputs) == 2 and {"lpips", "phys_mae"} <= set(res)
          and all(np.isfinite(v) for v in res.values()),
          f"path M: compute_metrics {res}")
    print(f"path M compute_metrics: {res} ({t_metrics:.2f} s, 36 launches "
          f"of K1 and K2 in each of {len(outputs)} forwards)")

    dev = torch.device("cuda")
    sr = torch.cat(outputs)
    gt = torch.cat([torch.from_numpy(b["gt"]).permute(0, 3, 1, 2)
                    for b in batches]).to(dev)
    short = torch.cat([torch.from_numpy(b["short_raw"]).permute(0, 3, 1, 2)
                       for b in batches]).to(dev)
    expo = torch.from_numpy(np.concatenate(
        [np.reshape(b["expo_ratio"], -1) for b in batches])).to(dev)
    sr_s, gt_s = linear_to_srgb(sr.clamp(0, 1)), linear_to_srgb(gt.clamp(0, 1))
    lp_vgg = M.LPIPSMetric(net="vgg", device=dev)
    metric_ms = {
        "psnr": wall_ms(lambda: float(M.psnr_linear(sr, gt))),
        "ssim": wall_ms(lambda: float(M.ssim_linear(sr, gt))),
        "rgb_psnr": wall_ms(lambda: M.rgb_psnr(sr, gt)),
        "deltaE": wall_ms(lambda: M.deltaE2000_summary(
            sr_s, gt_s, percentiles=(95.0,))),
        "edge_deltaE": wall_ms(lambda: M.edge_deltaE2000(
            sr_s, gt_s, edge_quantile=0.90)),
        "lpips_vgg": wall_ms(lambda: lp_vgg.distance(sr_s, gt_s)),
        "phys_mae": wall_ms(lambda: float(M.phys_cons_raw(sr, short, psf,
                                                          expo))),
    }
    niqe = []
    metric_ms["niqe"] = wall_ms(lambda: niqe.extend(
        M.calculate_niqe(sr_s[i].clamp(0, 1)) for i in range(2)))
    check(all(np.isfinite(niqe)), f"path M: NIQE {niqe}")
    print(f"path M metric wall ms (2 images of 512^2): {metric_ms}; "
          f"NIQE {niqe}")

    # LPIPS alex and vgg on the card against the same modules on the CPU
    # (centre 256^2 crops of both outputs)
    crop = lambda x: x[:, :, 128:384, 128:384]
    lpips_err = {}
    for lp_net in ("alex", "vgg"):
        card = M.LPIPSMetric(net=lp_net, device=dev).per_image(
            crop(sr_s), crop(gt_s))
        cpu = M.LPIPSMetric(net=lp_net, device="cpu").per_image(
            crop(sr_s).cpu(), crop(gt_s).cpu())
        lpips_err[lp_net] = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
        check(lpips_err[lp_net] <= 1e-4, f"path M: LPIPS-{lp_net} card "
              f"{card} vs CPU {cpu}")
    # InceptionV3 pool3 (random trunk) on the card against the CPU
    incep = M.inception_feature_extractor(allow_random=True, device=dev)
    incep_cpu = M.inception_feature_extractor(allow_random=True,
                                              device="cpu")
    f_card, f_cpu = incep(sr_s), incep_cpu(sr_s.cpu())
    incep_err = float(np.abs(f_card - f_cpu).max() / np.abs(f_cpu).max())
    check(f_card.shape == (2, 2048) and incep_err <= 1e-4,
          f"path M: Inception card vs CPU {incep_err:.3e} of max|feature|")
    # the VGG19 FID features with K7 against reduce_window
    vgg_fused = M.vgg_feature_extractor(pool_impl="kernel_fused", device=dev)
    vgg_plain = M.vgg_feature_extractor(pool_impl="reduce_window",
                                        device=dev)
    reset_launches()
    v_fused = vgg_fused(sr_s)
    expect_launches(launches(), "path M VGG19 FID extractor (kernel_fused)",
                    relu_pool_fwd=4)
    v_plain = vgg_plain(sr_s)
    vgg_err = float(np.abs(v_fused - v_plain).max() / np.abs(v_plain).max())
    check(vgg_err <= 1e-5, f"path M: VGG19 FID features kernel_fused vs "
          f"reduce_window {vgg_err:.3e}")
    print(f"path M card vs CPU: LPIPS rel {lpips_err}, Inception "
          f"{incep_err:.3e} of max|feature|; VGG19 FID features "
          f"kernel_fused vs reduce_window {vgg_err:.3e} (4 K7 launches)")

    # FLOPs on the plain path (meta tensors) against the analytic count
    meta = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                          device="meta")
    flops = M.FLOPsCounter(convention="macs").count(
        meta, torch.empty(1, 3, 512, 512, device="meta"))
    want = nafnet_macs(32, (2, 2, 4, 8), 12, (2, 2, 2, 2), 512, 512)
    check(flops.total == want, f"path M: count_flops {flops.total} MACs, "
          f"analytic {want}")
    x1 = torch.from_numpy(batches[0]["lq"]).permute(0, 3, 1, 2).to(dev)
    latency = M.measure_inference_time(eval_step, x1, warmup=3, runs=10)
    pair = (sr_s[:1] * 2 - 1, gt_s[:1] * 2 - 1)
    lpips_pair_ms = time_ms(lambda: lp_vgg.model(*pair), iters=5)
    b299 = torch.nn.functional.interpolate(sr_s, (299, 299))
    incep_ms = time_ms(lambda: incep.module(b299 * 2 - 1), iters=5)

    # one LPIPS-vgg pair and one Inception call at a quarter SID frame
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    big = [torch.rand(1, 3, *SID_QUARTER, generator=gen, device=dev)
           for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        big_lpips = lp_vgg.model(big[0] * 2 - 1, big[1] * 2 - 1)
        big_feat = incep.module(big[0] * 2 - 1)
    check(bool(torch.isfinite(big_lpips).all())
          and bool(torch.isfinite(big_feat).all()),
          "path M: LPIPS / Inception at 1424x2128 not finite")
    big_lpips_ms = time_ms(lambda: lp_vgg.model(big[0], big[1]), iters=3)
    big_incep_ms = time_ms(lambda: incep.module(big[0]), iters=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # achieved rates: FLOPs of the same calls counted on meta tensors
    lp_meta = M.LPIPSMetric(net="vgg", device="cpu").model
    rates = {
        "lpips_vgg_512_pair": (lp_meta, [(1, 3, 512, 512)] * 2,
                               lpips_pair_ms),
        "inception_2x299": (incep_cpu.module, [(2, 3, 299, 299)], incep_ms),
        "lpips_vgg_1424x2128_pair": (lp_meta, [(1, 3, *SID_QUARTER)] * 2,
                                     big_lpips_ms)}
    tflop_s = {}
    for key, (module, shapes, ms) in rates.items():
        n_flops = M.FLOPsCounter(convention="flops_2xmac").count(
            copy.deepcopy(module).to("meta"),
            *[torch.empty(sh, device="meta") for sh in shapes]).total
        tflop_s[key] = n_flops / (ms * 1e-3) / 1e12
    out = {"metrics": res, "compute_metrics_s": t_metrics,
           "metric_wall_ms": metric_ms, "niqe": niqe,
           "lpips_card_vs_cpu_rel": lpips_err,
           "inception_card_vs_cpu": incep_err,
           "vgg_fid_fused_vs_plain": vgg_err,
           "flops_macs_1x3x512": flops.total, "flops_backend":
           flops.metadata["backend"],
           "forward_ms_1x3x512": latency["ms_per_image"],
           "lpips_vgg_ms_per_512_pair": lpips_pair_ms,
           "inception_ms_per_299_batch_of_2": incep_ms,
           "lpips_vgg_ms_1424x2128_pair": big_lpips_ms,
           "inception_ms_1424x2128": big_incep_ms,
           "peak_gb_1424x2128": peak_gb, "fp32_tflop_s": tflop_s,
           "launches_per_forward": {"nafblk_a": 36, "nafblk_b": 36},
           "k7_launches_per_fid_call": 4}
    print(f"path M: forward {latency['ms_per_image']:.2f} ms at 1x3x512^2 "
          f"({flops.total / 1e9:.3f} GMACs by count_flops = analytic); "
          f"LPIPS-vgg {lpips_pair_ms:.2f} ms per 512^2 pair, Inception "
          f"{incep_ms:.2f} ms per 2x299^2 batch; at 1424x2128 LPIPS-vgg "
          f"{big_lpips_ms:.2f} ms a pair, Inception {big_incep_ms:.2f} ms, "
          f"peak {peak_gb:.2f} GB; fp32 TFLOP/s (count_flops of the same "
          f"calls / their time; peak 67 without TF32) {tflop_s}")
    print(json.dumps({"path_M": out}))
    os.environ.pop("SID_ROOT")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def lpips_loss_path(train_ms: float) -> dict:
    """Path L: the flagship recipe with ``hybrid_opt.use_lpips: true`` (its
    ``w_lpips`` 0.05; random LPIPS-vgg, as ``pretrained: false``) on the
    training phase's 2x3x384^2 batch: finite logs, ``l_lpips`` positive,
    36 launches of each of K1-K4 per step on the tensor-core route, a
    falling loss; the LPIPS term's fp32 input gradient at 2x3x128^2 on
    the card against the CPU in fp64 (1e-6 of max|g|; the fp32 readings
    printed beside the CPU's own fp32 error); ms/step beside the training
    phase's."""
    net, loss, state, step = recipe(TRAIN_CONFIG, None, 0.01,
                                    use_lpips=True)
    check(loss.lpips is not None and loss.w["lpips"] == 0.05,
          "path L: HybridLossPlus without its LPIPS-vgg term")
    four = dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)
    res = run_steps("NewBPNAFNet + LPIPS", step, state, flagship_batch(),
                    **four)
    expect_tensor_core_route(res["device_kernels"], "path L traced step",
                             backward=True)
    lp = [h["l_lpips"] for h in res["logs"]]
    check(all(np.isfinite(v) and v > 0 for v in lp),
          f"path L: l_lpips {lp}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    target = torch.rand(2, 3, 128, 128, generator=gen, device="cuda")
    pred = (target + 0.2 * torch.randn(target.shape, generator=gen,
                                       device="cuda")).clamp(0, 1)

    def term_grad(module, dt, device):
        p = pred.to(device, dt).requires_grad_(True)
        t = target.to(device, dt)
        val = module(p.clamp(0, 1) * 2 - 1, t.clamp(0, 1) * 2 - 1).mean()
        return torch.autograd.grad(val, p)[0].double().cpu()

    # The term's input gradient is piecewise smooth: where a ReLU input or
    # a max-pool pair lies within fp32 rounding of its switch, any two
    # fp32 computations (fp32 and fp64 on one CPU too) route a region of
    # it apart, by up to 1e-2 of max|g|. fp64 leaves no such switch: the
    # card is held to the CPU there; the fp32 readings are printed beside
    # the CPU's own fp32 error.
    lp_cpu = copy.deepcopy(loss.lpips).cpu()
    g = {"card32": term_grad(loss.lpips, torch.float32, "cuda"),
         "cpu32": term_grad(lp_cpu, torch.float32, "cpu"),
         "card64": term_grad(copy.deepcopy(loss.lpips).double(),
                             torch.float64, "cuda"),
         "cpu64": term_grad(lp_cpu.double(), torch.float64, "cpu")}
    gmax = g["cpu64"].abs().max().item()
    rel = lambda a, b: (g[a] - g[b]).abs().max().item() / gmax
    g_err = {"card64_vs_cpu64": rel("card64", "cpu64"),
             "card32_vs_cpu32": rel("card32", "cpu32"),
             "card32_vs_cpu64": rel("card32", "cpu64"),
             "cpu32_vs_cpu64": rel("cpu32", "cpu64")}
    check(gmax > 0 and g_err["card64_vs_cpu64"] <= 1e-6,
          f"path L: LPIPS fp64 input gradient card vs CPU "
          f"{g_err['card64_vs_cpu64']:.3e} of max|g| {gmax:.3e}")
    ratio = res["ms_per_step"] / train_ms
    print(f"path L: l_lpips {lp}; LPIPS input gradient, share of max|g|: "
          f"{g_err}; {res['ms_per_step']:.1f} ms/step, {ratio:.2f}x the "
          f"training phase's {train_ms:.1f} in this run")
    out = {"ms_per_step": res["ms_per_step"], "step_ms": res["step_ms"],
           "train_phase_ms_per_step": train_ms, "ratio_to_train_phase": ratio,
           "device_busy_ms": res["device_busy_ms"],
           "device_idle_share": res["device_idle_share"],
           "kernel_records": res["kernel_records"], "l_lpips": lp,
           "l_total": res["l_total"], "launches_per_step": four,
           "lpips_grad_rel": g_err}
    print(json.dumps({"path_L": out}))
    return out


def cli_path() -> dict:
    """The training CLI on the debug config as a user runs it, in a
    subprocess from a temporary working directory, on the card by default
    (``${DEBUG_SID_ROOT}`` self-provisioned), then ``test.py`` on its
    ``net_g_latest.pth``: rc 0, 16 iterations, the checkpoint, the
    validation line and the test results."""
    import os
    import tempfile

    import yaml

    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEBUG_SID_ROOT", "SID_ROOT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))

    def run(module: str, cfg: Path) -> str:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"lowlight_image_enhancement_tpu_torch.{module}",
             "-opt", str(cfg)], cwd=work, env=env, capture_output=True,
            text=True, timeout=600)
        log = proc.stdout + proc.stderr
        print(f"CLI {module}: rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s")
        check(proc.returncode == 0, f"CLI {module} failed:\n{log[-4000:]}")
        return log

    log = run("train", DEBUG_CONFIG)
    iters = [int(m.replace(",", ""))
             for m in re.findall(r"iter:\s*([\d,]+), lr", log)]
    latest = work / "experiments" / "sid_newbp_mono_debug" / "models" / \
        "net_g_latest.pth"
    check(sorted(set(iters)) == list(range(1, 17)) and latest.exists()
          and "m_psnr_linear" in log and "final validation" in log,
          f"CLI train: iterations {sorted(set(iters))}, checkpoint "
          f"{latest.exists()}")
    print("\n".join(line for line in log.splitlines()
                    if "iter:      16" in line or "final validation" in line))
    with open(DEBUG_CONFIG) as fh:
        cfg = yaml.safe_load(fh)
    cfg["path"]["pretrain_network_g"] = str(latest)
    with open(work / "eval.yml", "w") as fh:
        yaml.safe_dump(cfg, fh)
    log_t = run("test", work / "eval.yml")
    lines = [line for line in log_t.splitlines() if "[SID-debug-val]" in line]
    check(len(lines) == 1 and "psnr_linear" in lines[0],
          f"CLI test: no results line:\n{log_t[-2000:]}")
    print(lines[0])
    shutil.rmtree(work, ignore_errors=True)
    return {"iterations": max(iters), "test": lines[0]}


# ---------------------------------------------------------------------------
# K5-K8: kernel phase
# ---------------------------------------------------------------------------


def ln_pool_bound(kind: str, shape, dt: torch.dtype):
    """Least time (ms) for one call: bytes (each input read once, each
    output written once) over the HBM rate vs a few fp32 operations per
    element over the fp32 peak. All four are bound by bytes."""
    n, c, h, w = shape
    s = torch.tensor([], dtype=dt).element_size()
    elems = n * c * h * w
    if kind == "ln_fwd":      # x in; y, xhat (fp32), rstd out; w, b in
        nbytes = (2 * s + 4) * elems + 4 * n * h * w + 8 * c
        flops = 8 * elems
    elif kind == "ln_bwd":    # g, xhat, rstd, w in; gx, gw, gb out
        nbytes = (2 * s + 4) * elems + 4 * n * h * w + 12 * c
        flops = 11 * elems
    elif kind == "relu_pool_fwd":     # x in, y (a quarter) out
        nbytes = 1.25 * s * elems
        flops = 2 * elems
    else:                             # x, dy in, dx out
        nbytes = 2.25 * s * elems
        flops = 3 * elems
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def report_row(kind, rows, shape, dt, count, path, e, t_k, t_p, split, t_lib,
               lib_split):
    b_ms, b_by = ln_pool_bound(kind, shape, dt)
    n, c, h, w = shape
    dev = device_ms(split)
    # None: no main path calls the kernel at this shape, no window taken
    lib_dev = None if lib_split is None else device_ms(lib_split)
    rows.setdefault(kind, []).append(dict(
        path=path, n=n, c=c, h=h, w=w, dtype=str(dt)[6:], blocks=count,
        err=e, ms=t_k, device_ms=dev, device_split=split, plain_ms=t_p,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
        library_device_ms=lib_dev))
    print(f"  N={n:2d} C={c:4d} {h}x{w} {str(dt)[6:]:8s} {kind}: kernel "
          f"{t_k:.4f} ms (device {fmt_device(dev)})  plain {t_p:.4f} ms  "
          f"library {t_lib:.4f} ms (device {fmt_device(lib_dev)})  bound "
          f"{b_ms:.4f} ms ({b_by})")


def ln_phase(gen: torch.Generator, rows: dict) -> None:
    lib = _build.load("layernorm")
    for n, c, h, w, count, path in LN_SHAPES:
        shape = (n, c, h, w)
        # K6's grid is one round of blocks over the card only if the built
        # kernel places at least ln_bwd_blocks_per_sm blocks on an SM
        tile = ln.ln_bwd_tile(n, c, h * w)
        want = ln.ln_bwd_blocks_per_sm(c, tile)
        for bf in (0, 1):
            per_sm = lib.ln_bwd_blocks_per_sm(c, tile, bf)
            grid = ln.ln_bwd_grid(n, c, h * w, tile)
            print(f"  K6 C={c:4d} tile {tile:2d} grid {n}x{grid} "
                  f"{'bf16' if bf else 'fp32'}: {per_sm} blocks per SM "
                  f"(ops/layernorm.py counts {want})")
            check(per_sm >= want, f"K6 C={c} tile {tile}: {per_sm} blocks per "
                  f"SM, fewer than the {want} of ops/layernorm.py")
        x32 = torch.randn((n, c, h * w), generator=gen, device="cuda") * 2 \
            + 0.5
        g32 = torch.randn((n, c, h * w), generator=gen, device="cuda")
        wt = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        bt = 0.1 * torch.randn(c, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            y_k, xhat_k, rstd_k = ln.call_ln_fwd(x, wt, bt)
            y_p, xhat_p, rstd_p = ln.plain_ln_fwd(x, wt, bt)
            gx_k, gw_k, gb_k = ln.call_ln_bwd(g, xhat_p, rstd_p, wt)
            gx_2, gw_2, gb_2 = ln.call_ln_bwd(g, xhat_p, rstd_p, wt)
            gx_p, gw_p, gb_p = ln.plain_ln_bwd(g, xhat_p, rstd_p, wt)
            torch.cuda.synchronize()
            # no float atomics in K6: a second call gives the same bits
            check(torch.equal(gx_k, gx_2) and torch.equal(gw_k, gw_2)
                  and torch.equal(gb_k, gb_2),
                  f"K6 C={c} {h}x{w} {dt}: two calls differ")
            del gx_2, gw_2, gb_2
            checks = {"ln_fwd": err(y_k, y_p)}
            dims = f"{h}x{w} N={n}"
            show(checks, c, dims, dt)
            # the fp32 residuals and weight grads at the fp32 tolerance
            # in either activation type
            show({"ln_fwd.xhat": err(xhat_k, xhat_p),
                  "ln_fwd.rstd": err(rstd_k, rstd_p)}, c, dims,
                 torch.float32)
            checks["ln_bwd"] = err(gx_k, gx_p)
            show({"ln_bwd": checks["ln_bwd"]}, c, dims, dt)
            show({"ln_bwd.gw": err(gw_k, gw_p), "ln_bwd.gb": err(gb_k, gb_p)},
                 c, dims, torch.float32)

            # the library call: F.layer_norm on the channels-last view
            x_cl = x.transpose(1, 2).contiguous().requires_grad_(True)
            g_cl = g.transpose(1, 2).contiguous()
            w_lib = wt.to(dt).requires_grad_(True)
            b_lib = bt.to(dt).requires_grad_(True)
            lib_fwd = lambda: torch.nn.functional.layer_norm(
                x_cl, (c,), w_lib, b_lib, 1e-6)
            y_lib = lib_fwd()
            lib_bwd = lambda: torch.autograd.grad(
                y_lib, (x_cl, w_lib, b_lib), g_cl, retain_graph=True)
            with torch.no_grad():
                t5 = timed(lambda: ln.call_ln_fwd(x, wt, bt),
                           lambda: ln.plain_ln_fwd(x, wt, bt))
                t5 += timed_library(lib_fwd)
                t6 = timed(lambda: ln.call_ln_bwd(g, xhat_p, rstd_p, wt),
                           lambda: ln.plain_ln_bwd(g, xhat_p, rstd_p, wt))
            t6 += timed_library(lib_bwd, count)
            report_row("ln_fwd", rows, shape, dt, count, path,
                       checks["ln_fwd"][0], *t5)
            report_row("ln_bwd", rows, shape, dt, count, path,
                       checks["ln_bwd"][0], *t6)
            show_split(f"K6 {str(dt)[6:]} N={n} C={c} {h}x{w}", t6[2])
            del x_cl, g_cl, y_lib
        del x32, g32


def same(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Exact equality, a NaN equal to a NaN; returns max |got - ref| over
    the entries that are no NaN (0.0 when the check passes)."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} "
          f"{ref.dtype}")
    ok = (got == ref) | (got.isnan() & ref.isnan())
    bad = int((~ok).sum())
    print(f"  {what}: {bad} of {ok.numel()} entries differ (tolerance 0)")
    check(bad == 0, f"{what}: {bad} entries differ")
    return float((got.float() - ref.float()).nan_to_num(0.0).abs().max())


def pool_phase(gen: torch.Generator, rows: dict) -> None:
    for n, c, h, w, count, kind in POOL_SHAPES:
        shape = (n, c, h, w)
        x32 = torch.randn(shape, generator=gen, device="cuda")
        if kind == "ties":       # a handful of values: most windows tie
            values = torch.tensor([-1.0, -0.0, 0.0, 0.5, 2.0], device="cuda")
            x32 = values[torch.randint(0, 5, shape, generator=gen,
                                       device="cuda")]
        elif kind == "nan":
            x32[torch.rand(shape, generator=gen, device="cuda") < 0.1] = \
                float("nan")
        d32 = torch.randn((n, c, h // 2, w // 2), generator=gen,
                          device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), d32.to(dt)
            tag = f"N={n} C={c:3d} {h}x{w} {kind} {str(dt)[6:]}"
            geo = pool.pool_fwd_geometry_for(x)
            per_sm = pool.pool_fwd_blocks_per_sm(dt, geo.lv, geo.sv,
                                                 geo.bx * geo.by)
            print(f"  {tag} K7 geometry: {geo._asdict()}, {per_sm} blocks "
                  f"per SM")
            e7 = same(pool.call_relu_pool_fwd(x), pool.plain_relu_pool_fwd(x),
                      f"{tag} relu_pool_fwd")
            # x one element past its storage's 16-byte boundary: narrower
            # loads, the same result
            xo = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:]
            xo = xo.view(shape).copy_(x)
            same(pool.call_relu_pool_fwd(xo), pool.plain_relu_pool_fwd(xo),
                 f"{tag} relu_pool_fwd, x at an offset of one element "
                 f"(lv={pool.pool_fwd_geometry_for(xo).lv})")
            del xo
            e8 = max(same(pool.call_pool_bwd(x, dy, relu),
                          pool.plain_pool_bwd(x, dy, relu),
                          f"{tag} pool_bwd relu={relu}")
                     for relu in (True, False))
            torch.cuda.synchronize()
            xr = x.clone().requires_grad_(True)
            y_lib = torch.nn.functional.max_pool2d(xr, 2, 2)
            with torch.no_grad():
                lib7 = lambda: torch.nn.functional.max_pool2d(x, 2, 2)
                t7 = timed(lambda: pool.call_relu_pool_fwd(x),
                           lambda: pool.plain_relu_pool_fwd(x))
                t7 += timed_library(lib7, count)
                t8 = timed(lambda: pool.call_pool_bwd(x, dy, True),
                           lambda: pool.plain_pool_bwd(x, dy, True))
            lib8 = lambda: torch.autograd.grad(y_lib, xr, dy,
                                               retain_graph=True)
            t8 += timed_library(lib8, count)
            report_row("relu_pool_fwd", rows, shape, dt, count, kind, e7, *t7)
            report_row("pool_bwd", rows, shape, dt, count, kind, e8, *t8)
            del xr, y_lib
        del x32, d32


# ---------------------------------------------------------------------------
# paths P (perceptual loss, K7/K8), B (Baseline, K5/K6), S (NAFSSR)
# ---------------------------------------------------------------------------


# path P's timed steps under each pool option (the flagship step itself is
# timed by the training phase)
P_STEPS = 2


def perceptual_path() -> dict:
    batch = flagship_batch()
    four = dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)
    res, losses = {}, {}
    for impl, extra in (("kernel_fused", dict(relu_pool_fwd=8, pool_bwd=4)),
                        ("kernel_bwd", dict(pool_bwd=4))):
        net, loss, state, step = recipe(TRAIN_CONFIG, None, 0.01, impl)
        check(loss.perceptual.vgg.pool_impl == impl, "pool_impl not passed")
        res[impl] = run_steps(f"NewBPNAFNet pool_impl={impl}", step, state,
                              batch, P_STEPS, **four, **extra)
        losses[impl] = loss
        del net, state, step
    losses["reduce_window"] = build_hybrid_loss(
        parse(str(TRAIN_CONFIG), is_train=True)["train"], device="cuda")

    # the perceptual term and its gradient under the three options, fp32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    pred = (batch["gt"] + 0.2 * torch.randn(
        batch["gt"].shape, generator=gen, device="cuda")).requires_grad_(True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # same conv algorithms thrice
    out = {}
    try:
        for impl, loss in losses.items():
            loss.perceptual.vgg.dtype = torch.float32
            reset_launches()
            val = loss.perceptual(pred, batch["gt"])
            (grad,) = torch.autograd.grad(val, pred)
            out[impl] = (val.detach(), grad, launches())
    finally:
        torch.backends.cudnn.deterministic = was
    expect_launches(out["reduce_window"][2], "perceptual reduce_window")
    expect_launches(out["kernel_bwd"][2], "perceptual kernel_bwd", pool_bwd=4)
    expect_launches(out["kernel_fused"][2], "perceptual kernel_fused",
                    relu_pool_fwd=8, pool_bwd=4)
    v0, g0, _ = out["reduce_window"]
    gmax = g0.abs().max().item()
    check(gmax > 0 and bool(torch.isfinite(g0).all()),
          "perceptual gradient is zero or not finite")
    for impl in ("kernel_bwd", "kernel_fused"):
        v, g, _ = out[impl]
        dv = abs(float(v) - float(v0))
        dg = (g - g0).abs().max().item()
        print(f"perceptual term fp32, {impl} vs reduce_window: value "
              f"{float(v):.8g} vs {float(v0):.8g}, grad max_abs={dg:.3e} "
              f"max|g|={gmax:.3e} (limit 1e-6 * max|g|)")
        check(dv <= 1e-6 * abs(float(v0)), f"perceptual value under {impl}")
        check(dg <= 1e-6 * gmax, f"perceptual gradient under {impl}")
        res[impl]["grad_err"] = dg / gmax
    return res


def plain_layernorm(fn):
    """``fn()`` with every ``LayerNorm2d`` on the plain eager
    ``layer_norm_2d`` (under autograd; no K5/K6)."""
    kernel_forward = ln.LayerNorm2d.forward
    ln.LayerNorm2d.forward = lambda self, x: ln.layer_norm_2d(
        x, self.weight, self.bias, self.eps)
    try:
        reset_launches()
        out = fn()
        check(ln.call_ln_fwd.launches == 0 and ln.call_ln_bwd.launches == 0,
              "the plain LayerNorm run launched K5/K6")
        return out
    finally:
        ln.LayerNorm2d.forward = kernel_forward


def baseline_path() -> dict:
    net, loss, state, step = recipe(TRAIN_CONFIG, BASELINE_W32, 0.01)
    norms = [m for m in net.modules() if isinstance(m, ln.LayerNorm2d)]
    check(len(norms) == 72 and net.dtype == torch.bfloat16,
          "Baseline-width32 must hold 72 LayerNorms and run in bf16")
    batch = flagship_batch()
    res = run_steps("Baseline", step, state, batch, ln_fwd=72, ln_bwd=72)
    eval_forward("Baseline", net, batch["lq"], batch["lq"].shape, ln_fwd=72)

    # fp32 gradients through K5/K6 vs the plain LayerNorm
    amp_dt = net.dtype
    set_dtype(net, loss, torch.float32)
    params = list(net.parameters())
    names = [k for k, _ in net.named_parameters()]

    def grads():
        out = net(batch["lq"])
        total, _ = loss(**hybrid_batch_kwargs(out, batch))
        return torch.autograd.grad(total, params)

    reset_launches()
    g_kernel = grads()
    check(ln.call_ln_fwd.launches == 72 and ln.call_ln_bwd.launches == 72,
          "fp32 check did not run K5/K6 72 times")
    res["grad_check_worst"] = compare_grads(
        "Baseline, K5/K6 vs plain LayerNorm", names, g_kernel,
        plain_layernorm(grads))
    set_dtype(net, loss, amp_dt)
    del g_kernel, state, step

    serve = serve_mix(net, "Baseline", ln_fwd=72)
    res["serve_wall_s"] = serve["wall_s"]
    res["serve_launches"] = serve["launches"]

    # every served request (the buckets and the tiled one) through K5 vs
    # the same request with the plain LayerNorm
    server, images = serve["server"], serve["images"]
    res["serve_err"] = {}
    for dt in SERVE_TOL:
        net.dtype = dt
        reset_launches()
        got = serve["outputs"] if dt == amp_dt else server.predict(images)
        check(dt == amp_dt or ln.call_ln_fwd.launches > 0,
              "the served fp32 requests did not run K5")
        ref = plain_layernorm(lambda: server.predict(images))
        res["serve_err"][str(dt)[6:]] = served_err(
            "Baseline, K5 vs plain LayerNorm", dt, got, ref)
    net.dtype = amp_dt
    return res


def nafssr_path() -> dict:
    net, loss, state, step = recipe(STEREO_CONFIG, None, 0.01)
    check(len(net.blocks()) == 16 and net.blocks()[0].conv1.in_channels == 48
          and all(b.scam is not None and b.drop_path.rate == 0.1
                  for b in net.body), "NAFSSR must be the config's network")
    net.generator = torch.Generator(device="cuda").manual_seed(SEED)
    # a seeded synthetic batch of the config's size: 16 stereo pairs, 60x180
    # targets and their 2x2-averaged 30x90 inputs
    rng = np.random.default_rng(SEED)
    gt = torch.from_numpy(rng.uniform(0, 1, (16, 6, 60, 180))
                          .astype(np.float32)).cuda()
    batch = {"lq": torch.nn.functional.avg_pool2d(gt, 2), "gt": gt}
    per_step = dict(nafblk_a=32, nafblk_b=32, nafblk_p1=32, nafblk_p2=32,
                    ln_fwd=32, ln_bwd=32)
    res = run_steps("NAFSSR", step, state, batch, **per_step)
    eval_forward("NAFSSR", net, batch["lq"], gt.shape, nafblk_a=32,
                 nafblk_b=32, ln_fwd=32)

    # fp32 gradients through K5/K6 vs the plain LayerNorm (eval mode: no
    # drop-path draw, so both runs see the same network)
    check(net.dtype == torch.float32, "the stereo recipe trains in fp32")
    net.eval()
    params = list(net.parameters())
    names = [k for k, _ in net.named_parameters()]

    def grads():
        return torch.autograd.grad(
            ((net(batch["lq"]) - gt) ** 2).mean(), params)

    reset_launches()
    g_kernel = grads()
    check(ln.call_ln_fwd.launches == 32 and ln.call_ln_bwd.launches == 32,
          "fp32 check did not run K5/K6 32 times")
    res["grad_check_worst"] = compare_grads(
        "NAFSSR, K5/K6 vs plain LayerNorm", names, g_kernel,
        plain_layernorm(grads))
    return res


# ---------------------------------------------------------------------------
# parallel paths: DP (data-parallel training), SP (the spatial forward),
# the two-rank Trainer, the torchrun CLI, the serving mesh and the sharded
# export
# ---------------------------------------------------------------------------
# 1 warm-up, 3 timed and 1 traced step
DP_STEPS = 5
DP_TRACED = DP_STEPS - 1
# one SID Sony frame: 2848 = 89 * 32 and 4256 = 266 * 16, so the height
# splits into 2 shards that stay even through NewBPNAFNet's 4 downs
SP_FRAME = (1, 3, 2848, 4256)
# the bf16 gradients of 1 + 1 images against one process's 2, per leaf
# against its own max|g|: a reading beside this share (dp_grad_checks);
# ZeRO-1 against replicated: JAX's bar
DP_GRAD_TOL = 2.0 ** -6
ZERO1_TOL = 2e-6
SP_TOL = 1e-4


def short_kernel_name(name: str) -> str:
    """A device kernel's identifier as :func:`device_records` keys it."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"<.*", "", name)
    return re.sub(r"^void\s+", "", name.split("(")[0]).strip()


def dp_spec() -> dict:
    """The flagship recipe's step as ``parallel.launch.train_steps`` takes
    it: ``network_g`` in bf16 with seeded random weights (residual scales
    0.01, as the training phase), the config's ``train`` block, the seeded
    2x3x384^2 batch."""
    opt = parse(str(TRAIN_CONFIG), is_train=True)
    network_g = {**opt["network_g"], "dtype": "bfloat16"}
    net = define_network(network_g, device="cuda")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED), 0.01)
    state_dict = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    batch = {k: v.cpu().numpy() for k, v in flagship_batch().items()}
    return dict(network_g=network_g, train=copy.deepcopy(opt["train"]),
                state_dict=state_dict, batch=batch, steps=DP_STEPS,
                trace_step=DP_TRACED, grads=True, device="cuda")


def dp_checks(what: str, run: dict, per_step: dict) -> float:
    """Every step's launches, finite logs, the tensor-core route of the
    traced step; returns the median ms of the timed steps."""
    for i, counts in enumerate(run["launches"]):
        expect_launches(counts, f"{what} step {i}", **per_step)
        assert_finite_logs(run["logs"][i])
    expect_tensor_core_route({short_kernel_name(k)
                              for k in run["device_kernels"]},
                             f"{what} traced step", backward=True)
    ms = statistics.median(run["ms"][1:DP_TRACED])
    print(f"{what}: ms/step {ms:.1f} (host clock; steps "
          f"{[round(t, 1) for t in run['ms']]}, step {DP_TRACED} traced), "
          f"l_total {[round(lg['l_total'], 6) for lg in run['logs']]}")
    return ms


def dp_grad_checks(rank: dict, ref: dict, singles: list) -> tuple:
    """The first step's all-reduced gradients of a rank of (b) against the
    mean of the two single-image steps of one process (what the ranks
    compute alone, then average): equal bits in every leaf. Printed
    beside it: how far they lie from the one-process 2-image step, per
    leaf against its own max|g| and against the gradient's max|g| -- in
    bf16 a batch of 1 rounds otherwise than a batch of 2, which moves
    the deep, small gradients most. Returns (the largest leaf difference
    from the 2-image step over the gradient's max|g|, the largest over
    its own leaf's max|g|)."""
    names = rank["names"] + ["log_sigma"] * len(rank["grads"])
    means = [(a + c) / np.float32(2) for a, c in zip(*singles)]
    gmax = max(float(np.abs(w).max()) for w in ref["grads"])
    equal = [k for g, m, k in zip(rank["grads"], means, names)
             if g.shape == m.shape and np.array_equal(g, m)]
    rows = sorted(((float(np.abs(g - w).max()), float(np.abs(w).max()), k)
                   for g, w, k in zip(rank["grads"], ref["grads"], names)),
                  key=lambda r: r[0] / max(r[1], 1e-30), reverse=True)
    own = [r[0] / max(r[1], 1e-30) for r in rows]
    worst = max(r[0] for r in rows) / gmax
    print(f"DP (b): first step's all-reduced gradients equal the mean of "
          f"the two single-image steps, bit for bit, in {len(equal)} of "
          f"{len(means)} leaves; against the one-process 2-image step "
          f"(a reading): largest leaf difference / its own max|g| "
          f"{own[0]:.3e} ({rows[0][2]}, max|g| {rows[0][1]:.3e}), "
          f"{sum(o > DP_GRAD_TOL for o in own)} of {len(own)} leaves above "
          f"{DP_GRAD_TOL:.3e}; / the gradient's max|g| ({gmax:.3e}) "
          f"{worst:.3e}")
    check(len(rank["grads"]) == len(means) == len(equal),
          "DP (b): the all-reduced gradients are not the mean of the "
          "single-image steps")
    return worst, own[0]


def collective_line(what: str, stats: dict, grad_bytes: int) -> dict:
    from lowlight_image_enhancement_tpu_torch.parallel.introspect import (
        bulk_and_scalar)

    split = bulk_and_scalar(stats)
    ar = split.get("all-reduce", {"bulk_count": 0, "bulk_bytes": 0})
    print(f"{what} collectives of one step: {json.dumps(split)}; bulk "
          f"all-reduce bytes {ar['bulk_bytes']} = "
          f"{ar['bulk_bytes'] / grad_bytes:.4f} x the fp32 gradient bytes "
          f"{grad_bytes}")
    check(1 <= ar["bulk_count"] <= 8 and 0.95 * grad_bytes
          <= ar["bulk_bytes"] <= 1.10 * grad_bytes,
          f"{what}: bulk all-reduces {ar}, gradient bytes {grad_bytes}")
    return split


def sp_inputs() -> tuple:
    """The serving ``NewBPNAFNet`` in fp32 with seeded random weights (the
    serving phase's residual scale 0.1), one seeded SID-frame-sized input,
    and the single-device forward of the unfused blocks
    (``NAFBlock.forward_eager``) on it."""
    network_g = {"type": "NewBPNAFNet", "dtype": "float32"}
    net = define_network(network_g, device="cuda")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED), 0.1)
    x = np.random.default_rng(SEED).uniform(0, 1, SP_FRAME).astype(
        np.float32)
    for b in net.blocks():
        b.fused = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(torch.from_numpy(x).cuda()).cpu().numpy()
    torch.cuda.synchronize()
    print(f"path SP: single-device forward (unfused blocks) of "
          f"{'x'.join(map(str, SP_FRAME))} fp32 in "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    spec = dict(network_g=network_g, state_dict={
        k: v.detach().cpu() for k, v in net.state_dict().items()}, x=x)
    del net
    return spec, ref


def sp_check(what: str, run: dict, ref: np.ndarray) -> float:
    e = float(np.abs(run["out"] - ref).max())
    scale = float(np.abs(ref).max())
    print(f"{what}: max_abs={e:.3e} max|ref|={scale:.3e} (tol {SP_TOL:.0e} "
          f"* max|ref|), {run['ln_fwd_launches']} K5 launches, "
          f"{run['ms']:.0f} ms, peak {run['peak_bytes'] / 2**30:.2f} GiB")
    check(run["out"].shape == ref.shape and bool(np.isfinite(run["out"]).all())
          and e <= SP_TOL * scale, f"{what}: off the single-device forward")
    check(run["ln_fwd_launches"] == 72,
          f"{what}: {run['ln_fwd_launches']} K5 launches, expected 72")
    return e


def parallel_trainer_opt(tmp: Path) -> dict:
    """The flagship config over path T's synthetic SID tree for the
    two-rank Trainer: 4 iterations, ``train.zero1``, checkpoints every 2,
    validation at 4; center crops and 2 samples a pair, so that each rank
    has 2 iterations an epoch and the resume at 2 starts epoch 1, whose
    batches are iterations 3-4's."""
    import os

    os.environ["SID_ROOT"] = str(synthetic_sid_root(tmp / "sid"))
    opt = parse(str(TRAIN_CONFIG), is_train=True, root_dir=str(tmp / "exp"))
    opt["train"].update(total_iter=T_STEPS, zero1=True)
    opt["datasets"]["train"].update(samples_per_pair=2, random_crop=False)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=T_SAVE,
                         use_tb_logger=False)
    opt["val"]["val_freq"] = T_STEPS
    return opt


def trainer_checks(outs: list, metrics) -> dict:
    for r, out in enumerate(outs):
        hist = out["history"]
        check(out["zero1"] and out["step"] == T_STEPS
              and [h["iter"] for h in hist] == list(range(1, T_STEPS + 1))
              and all(np.isfinite(list(h.values())).all() for h in hist),
              f"two-rank Trainer rank {r}: {hist}")
        check(sorted(out["val"]) == sorted(metrics)
              and all(np.isfinite(v) for v in out["val"].values()),
              f"two-rank Trainer rank {r}: validation {out['val']}")
        got = [h["l_total"] for h in out["resumed_history"]]
        want = [h["l_total"] for h in hist[T_SAVE:]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"two-rank Trainer rank {r}: l_total {[h['l_total'] for h in hist]}"
              f", resumed at {out['resumed_from']}: {got} (max rel "
              f"{rel:.2e}), validation {out['val']}, optimizer state "
              f"{out['state_bytes'] / 2**20:.1f} MiB")
        check(out["resumed_from"] == T_SAVE and len(got) == len(want)
              and rel <= 1e-3, f"two-rank Trainer rank {r}: the resume at "
              f"{T_SAVE} gives {got}, not {want}")
    check([h["l_total"] for h in outs[0]["history"]]
          == [h["l_total"] for h in outs[1]["history"]],
          "two-rank Trainer: the ranks logged different losses")
    check(outs[0]["val"] == outs[1]["val"],
          "two-rank Trainer: the ranks validated differently")
    return {"l_total": [h["l_total"] for h in outs[0]["history"]],
            "resumed_l_total": [h["l_total"]
                                for h in outs[0]["resumed_history"]],
            "val_metrics": outs[0]["val"],
            "state_bytes_per_rank": outs[0]["state_bytes"]}


def parallel_path() -> dict:
    """Paths DP and SP and the two-rank Trainer.

    DP (a): the flagship step in this process, first without a mesh, then
    in a world of 1 on NCCL (``init_multihost``): equal parameters, bit
    for bit, 36 launches of K1-K4 a step on the tensor cores, 1-8 bulk
    all-reduces of the fp32 gradient bytes and no bulk all-gather.
    SP at world 1: ``nafnet_apply_spatial`` of a SID frame, 72 K5 launches,
    against the single-device forward of the unfused blocks.
    Then one spawned world of 2 ranks over gloo on the one card runs, in
    turn: DP (b), each rank one image of the batch (both ranks equal, the
    first step's all-reduced gradients against the one-process step's,
    l_total); DP (c), the same with ZeRO-1 (parameters against (b)'s,
    moment bytes, a bulk all-gather); SP (each rank's output against
    world 1's, its peak memory); the Trainer on path T's tree with
    ``train.zero1`` and its resume."""
    import os
    import tempfile

    import torch.distributed as dist

    from lowlight_image_enhancement_tpu_torch.parallel import launch
    from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
        init_multihost)

    four = dict(nafblk_a=36, nafblk_b=36, nafblk_p1=36, nafblk_p2=36)
    # cuDNN's deterministic algorithms (two runs of a step give equal
    # bits) and no TF32 (the fp32 convolutions stay fp32), here and in the
    # spawned ranks, which start from PyTorch's defaults
    cudnn = {"deterministic": True, "allow_tf32": False}
    saved = {k: getattr(torch.backends.cudnn, k) for k in cudnn}
    for k, v in cudnn.items():
        setattr(torch.backends.cudnn, k, v)
    spec = dp_spec()
    sp_spec, sp_ref = sp_inputs()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        ref = launch.train_steps(spec)
        ms_ref = dp_checks("DP one process, no mesh", ref, four)
        grad_bytes = sum(p.size * 4 for p in ref["params"])
        # the first step of each image alone: what each rank of (b) takes
        singles = [launch.train_steps(dict(
            spec, steps=1, trace_step=None,
            batch={k: v[i:i + 1] for k, v in spec["batch"].items()}))
            ["grads"] for i in range(2)]
        init_multihost(f"file://{tmp / 'rendezvous'}", 1, 0,
                       backend="nccl", device="cuda:0")
        try:
            check(dist.get_backend() == "nccl" and dist.get_world_size()
                  == 1, "DP (a): a world of 1 on NCCL")
            w1 = launch.train_steps(spec)
            sp1 = launch.spatial_run(sp_spec)
        finally:
            dist.destroy_process_group()
        ms_a = dp_checks("DP (a) world 1 on NCCL", w1, four)
        same = all(np.array_equal(a, b) for a, b in
                   zip(w1["params"], ref["params"]))
        check(same, "DP (a): parameters differ from the steps without a "
              "mesh")
        print(f"DP (a): parameters after {DP_STEPS} steps equal those "
              f"without a mesh, bit for bit")
        split_a = collective_line("DP (a)", w1["stats"], grad_bytes)
        check(split_a.get("all-gather", {}).get("bulk_count", 0) == 0,
              f"DP (a): a bulk all-gather {split_a}")
        sp1_err = sp_check("path SP world 1 (NCCL)", sp1, sp_ref)
        torch.cuda.empty_cache()

        opt = parallel_trainer_opt(tmp)
        calls = [(launch.train_steps, (spec,)),
                 (launch.train_steps, (dict(spec, zero1=True),)),
                 (launch.spatial_run, (sp_spec,)),
                 (launch.run_trainer, (opt, T_SAVE))]
        t0 = time.perf_counter()
        outs = launch.spawn(launch.sequence, 2, backend="gloo",
                            device="cuda:0", args=(calls,), cudnn=cudnn)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)
        os.environ.pop("SID_ROOT", None)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"two ranks over gloo on cuda:0: {wall:.1f} s (process start "
          f"included)")
    b = [o[0] for o in outs]
    z = [o[1] for o in outs]
    sp2 = [o[2] for o in outs]

    # DP (b): each rank one image
    ms_b = [dp_checks(f"DP (b) rank {r} (gloo)", run, four)
            for r, run in enumerate(b)]
    check(all(np.array_equal(x, y) for x, y in
              zip(b[0]["params"], b[1]["params"])),
          "DP (b): the ranks' parameters differ")
    worst, leaf_worst = dp_grad_checks(b[0], ref, singles)
    lt = [(run["logs"][0]["l_total"], ref["logs"][0]["l_total"]) for run in b]
    rel_l = max(abs(a - r) / abs(r) for a, r in lt)
    print(f"DP (b): first step's l_total {lt} (max rel {rel_l:.2e}, tol "
          f"1e-2)")
    check(rel_l <= 1e-2, "DP (b): l_total off the one-process step")
    split_b = collective_line("DP (b) rank 0", b[0]["stats"], grad_bytes)

    # DP (c): ZeRO-1
    ms_c = [dp_checks(f"DP (c) ZeRO-1 rank {r} (gloo)", run, four)
            for r, run in enumerate(z)]
    diff = max(float(np.abs(x - y).max()) for x, y in
               zip(z[0]["params"], b[0]["params"]))
    print(f"DP (c): parameters after {DP_STEPS} steps vs the replicated "
          f"two-rank run: max_abs {diff:.3e} (tol {ZERO1_TOL:.0e}); "
          f"optimizer state per rank {z[0]['state_bytes'] / 2**20:.1f} MiB "
          f"against {b[0]['state_bytes'] / 2**20:.1f} MiB replicated "
          f"({z[0]['state_bytes'] / b[0]['state_bytes']:.3f})")
    for x, y in zip(z[0]["params"], b[0]["params"]):
        check(bool(np.allclose(x, y, atol=ZERO1_TOL, rtol=ZERO1_TOL)),
              "DP (c): ZeRO-1 parameters off the replicated run's")
    check(z[0]["state_bytes"] < 0.6 * b[0]["state_bytes"],
          "DP (c): the moments are not sharded")
    split_c = collective_line("DP (c) rank 0", z[0]["stats"], grad_bytes)
    check(split_c.get("all-gather", {}).get("bulk_count", 0) >= 1,
          f"DP (c): no bulk all-gather {split_c}")

    # SP over the two ranks
    for r, run in enumerate(sp2):
        sp_check(f"path SP rank {r} of 2 (gloo)", run, sp_ref)
        e = float(np.abs(run["out"] - sp1["out"]).max())
        print(f"path SP rank {r}: vs world 1 max_abs={e:.3e}; peak "
              f"{run['peak_bytes'] / 2**30:.2f} GiB against world 1's "
              f"{sp1['peak_bytes'] / 2**30:.2f} GiB "
              f"({run['peak_bytes'] / sp1['peak_bytes']:.3f})")
        check(e <= SP_TOL * float(np.abs(sp_ref).max()),
              f"path SP rank {r}: off the world-1 output")
    trainer = trainer_checks([o[3] for o in outs],
                             list(opt["val"]["metrics"]))
    return {
        "launches_per_step": four, "sp_launches_per_forward": {"ln_fwd": 72},
        "ms_per_step": {"one_process": ms_ref, "a_world1_nccl": ms_a,
                        "b_gloo_2ranks": ms_b, "c_zero1_2ranks": ms_c},
        "collectives": {"a": split_a, "b": split_b, "c": split_c},
        "grad_bytes": grad_bytes, "b_grad_worst": worst,
        "b_grad_worst_of_own_leaf": leaf_worst,
        "b_l_total_rel": rel_l, "c_params_max_abs": diff,
        "state_bytes": {"replicated": b[0]["state_bytes"],
                        "zero1": z[0]["state_bytes"]},
        "sp": {"world1_err": sp1_err, "world1_ms": sp1["ms"],
               "world1_peak_bytes": sp1["peak_bytes"],
               "rank_ms": [r["ms"] for r in sp2],
               "rank_peak_bytes": [r["peak_bytes"] for r in sp2]},
        "trainer": trainer, "two_rank_wall_s": wall}


def torchrun_cli_path() -> dict:
    """``torchrun --standalone --nproc_per_node=1 -m
    lowlight_image_enhancement_tpu_torch.train -opt <debug config>
    --launcher pytorch`` (``python -m torch.distributed.run``) from a
    temporary working directory: a world of 1 on NCCL, rc 0, 16
    iterations and the final validation."""
    import os
    import tempfile

    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_torchrun_"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEBUG_SID_ROOT", "SID_ROOT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "lowlight_image_enhancement_tpu_torch.train",
         "-opt", str(DEBUG_CONFIG), "--launcher", "pytorch"], cwd=work,
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    iters = [int(m.replace(",", ""))
             for m in re.findall(r"iter:\s*([\d,]+), lr", log)]
    print(f"torchrun CLI: rc {proc.returncode} in {wall:.1f} s, iterations "
          f"{sorted(set(iters))[-1:] or 'none'}")
    check(proc.returncode == 0, f"torchrun CLI failed:\n{log[-4000:]}")
    check(sorted(set(iters)) == list(range(1, 17))
          and "final validation" in log, "torchrun CLI: 16 iterations and "
          "the final validation")
    shutil.rmtree(work, ignore_errors=True)
    return {"rc": proc.returncode, "wall_s": wall, "iterations": max(iters)}


def mesh_serving_path(gen: torch.Generator) -> dict:
    """The serving mesh and the sharded export at one device:
    ``RestorationServer(mesh=create_mesh(devices=["cuda:0"]))`` serves the
    8-request mix equal to the server without a mesh (36 K1/K2 launches a
    forward); ``export_model(..., mesh=)`` records the mesh, and a fresh
    ``ExportedModel`` serves ``predict_batch`` against the live forward
    (36 K1/K2 launches per exported forward)."""
    import tempfile

    from lowlight_image_enhancement_tpu_torch.export import (
        ClippedForward, ExportedModel, export_model, net_state)
    from lowlight_image_enhancement_tpu_torch.parallel import create_mesh

    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda")
    randomize_(net, gen, 0.1)
    mesh = create_mesh(devices=["cuda:0"])
    plain = serve_mix(net, "NewBPNAFNet without a mesh", nafblk_a=36,
                      nafblk_b=36)
    meshed = serve_mix(net, "NewBPNAFNet on a 1-device mesh", mesh=mesh,
                       nafblk_a=36, nafblk_b=36)
    equal = all(np.array_equal(a, b) for a, b in
                zip(plain["outputs"], meshed["outputs"]))
    check(equal, "serving mesh: outputs differ from the server's without")
    print("serving mesh: the 8 requests equal the server without a mesh, "
          "bit for bit")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_export_"))
    export_model(net, str(tmp), buckets=[(256, 384)], batch=1, mesh=mesh,
                 network_opt={"type": "NewBPNAFNet"})
    with open(tmp / "manifest.json") as fh:
        manifest = json.load(fh)
    check(manifest["mesh"] == {"axis": "data", "size": 1},
          f"sharded export: manifest mesh {manifest['mesh']}")
    model = ExportedModel(str(tmp))
    check(model.mesh is not None and model.mesh.size == 1,
          "sharded export: ExportedModel has no mesh of 1")
    rng = np.random.default_rng(SEED)
    imgs = [rng.uniform(0, 1, (256, 384, 3)).astype(np.float32),
            rng.uniform(0, 1, (200, 300, 3)).astype(np.float32)]
    model.predict_batch(imgs[:1])          # warm-up
    torch.cuda.synchronize()
    reset_launches()
    got = model.predict_batch(imgs)
    torch.cuda.synchronize()
    expect_launches(launches(), "sharded export predict_batch of 2",
                    nafblk_a=72, nafblk_b=72)
    errs = []
    for g, im in zip(got, imgs):
        x = np.zeros((1, 256, 384, 3), np.float32)
        x[0, :im.shape[0], :im.shape[1]] = im
        with torch.no_grad():
            want = ClippedForward(net)(net_state(net),
                                       torch.from_numpy(x).cuda())
        want = want.cpu().numpy()[0, :im.shape[0], :im.shape[1]]
        errs.append(exported_vs_live(
            f"sharded export (mesh of 1) {im.shape[0]}x{im.shape[1]}", g,
            want))
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": meshed["launches"], "wall_s": meshed["wall_s"],
            "unmeshed_wall_s": plain["wall_s"],
            "export_launches_per_forward": {"nafblk_a": 36, "nafblk_b": 36},
            "export_err": errs}


# path U: the user's tools (lowlight_image_enhancement_tpu_torch/tools), the
# multi-worker loader and the backend probe
U_PAIRS = 4        # pair ids of the PNG tree: half train, half val
U_SIDE = 512
U_E2E_STEPS = 30   # train_pipeline_e2e --steps
OVERFIT_BLOCKS = 5  # debug_overfit's NAFNet: (1,1)/1/(1,1)
OVERFIT_STEPS = 50  # a phase (the tool's default is 200)


def png_tree(root: Path) -> Path:
    """A SID-named tree of 16-bit PNGs (``short/<id>_00_0.1s.png``,
    ``long/<id>_00_10s.png``: ratio 100), ``U_PAIRS`` seeded 512^2 pairs:
    a smooth long frame and its dark, noisy short."""
    from lowlight_image_enhancement_tpu_torch.utils import imgio

    rng = np.random.default_rng(SEED)
    for sub in ("short", "long"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for i in range(U_PAIRS):
        base = rng.uniform(0.05, 0.9, (U_SIDE // 64, U_SIDE // 64, 3))
        long_img = np.clip(np.kron(base, np.ones((64, 64, 1)))
                           + rng.normal(0, 0.02, (U_SIDE, U_SIDE, 3)), 0, 1)
        short = np.clip(long_img / 100.0
                        + rng.normal(0, 0.002, long_img.shape), 0, 1)
        imgio.imwrite(str(root / "long" / f"{i:05d}_00_10s.png"),
                      (long_img * 65535).astype(np.uint16))
        imgio.imwrite(str(root / "short" / f"{i:05d}_00_0.1s.png"),
                      (short * 65535).astype(np.uint16))
    return root


def profiled(fn):
    """``(fn(), device kernel records)`` of one call under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, device_records(prof.key_averages())


def tools_path() -> dict:
    """Path U: the user's tools on the card. A PNG tree ->
    ``tools/prepare_sid_manifest.py`` (no package) -> the port's
    ``create_sid_pack`` -> ``debug_dataset`` and ``SonySIDDataset`` reading
    the packs back against the PNGs; ``evaluate`` of the serving
    ``NewBPNAFNet`` (full width and depth, bf16, seeded, weights as
    ``.pth``) over the val split against a direct ``compute_metrics``
    (36 K1/K2 launches a forward on the tensor cores) and ``--identity``;
    ``profile_train`` at its defaults (36 launches of K1-K4 a step, the
    tensor-core route in a traced run); ``profile_step_families`` naming
    K1-K4's device kernels; ``debug_overfit --steps 50`` (both phases
    fall, K1-K4 on the FMA route at C = 8, 16, 32); ``train_pipeline_e2e --steps 30
    --workers 2``; ``make_grain_loader(worker_count=2)`` over the packs
    into ``prefetch_to_device``; ``probe_backend() == "cuda"``."""
    import os
    import tempfile

    import yaml

    from lowlight_image_enhancement_tpu_torch.data import (
        SonySIDDataset, create_dataset, create_loader, prefetch_to_device)
    from lowlight_image_enhancement_tpu_torch.data.grain_pipeline import (
        make_grain_loader)
    from lowlight_image_enhancement_tpu_torch.data.transforms import (
        decode_png_uint16, uint16_to_float01)
    from lowlight_image_enhancement_tpu_torch.demo import load_weights
    from lowlight_image_enhancement_tpu_torch.metrics import compute_metrics
    from lowlight_image_enhancement_tpu_torch.tools import (
        create_sid_pack, debug_dataset, debug_overfit, evaluate,
        profile_step_families, profile_train, train_pipeline_e2e)
    from lowlight_image_enhancement_tpu_torch.utils.backend_probe import (
        probe_backend)

    repo = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_path_u_"))
    secs: dict = {}
    t0 = time.perf_counter()

    # 1. PNG tree -> manifest -> packs -> read back
    tree = png_tree(tmp / "png")
    sid = tmp / "sid"
    manifest = sid / "SID_assets" / "manifest_sid.json"
    res = subprocess.run(
        [sys.executable, str(repo / "tools" / "prepare_sid_manifest.py"),
         "--root", str(tree), "--output", str(manifest),
         "--val-fraction", "0.5", "--test-fraction", "0"],
        capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"prepare_sid_manifest: {res.stderr[-2000:]}")
    packs = sid / "SID_pack"
    written = create_sid_pack.main(["--manifest", str(manifest), "--root",
                                    str(tree), "--output", str(packs)])
    check({k: v["shorts"] for k, v in written.items()}
          == {"train": U_PAIRS // 2, "val": U_PAIRS // 2},
          f"path U create_sid_pack: {written}")
    sanity = debug_dataset.check(str(manifest),
                                 str(packs / "train_short.pack"),
                                 str(packs / "train_long.pack"), "train")
    check(not sanity["missing_short"] and not sanity["missing_long"]
          and sanity["aligned_err"] < 1e-6,
          f"path U debug_dataset: {sanity}")
    val_ds = SonySIDDataset(
        str(manifest), subset="val", phase="val",
        io_backend={"type": "pack", "short_path": str(packs /
                                                     "val_short.pack"),
                    "long_path": str(packs / "val_long.pack")})
    for idx, rec in enumerate(val_ds.records):
        item = val_ds[idx]
        for which, key in (("short_raw", "short"), ("gt", "long")):
            png = (tree / key / f"{rec[key + '_key']}.png").read_bytes()
            check(np.array_equal(item[which],
                                 uint16_to_float01(decode_png_uint16(png))),
                  f"path U: {rec[key + '_key']} read back from the pack")
    print(f"path U packs: {written}; debug_dataset {sanity}; "
          f"{len(val_ds)} val pairs read back equal to their PNGs")
    secs["packs"] = time.perf_counter() - t0

    # 2. evaluate against a direct compute_metrics
    t0 = time.perf_counter()
    with open(TRAIN_CONFIG) as fh:
        cfg = yaml.safe_load(fh)
    cfg["network_g"]["dtype"] = "bfloat16"
    cfg_path = tmp / "evaluate.yml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    old_root = os.environ.get("SID_ROOT")
    os.environ["SID_ROOT"] = str(sid)
    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda")
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED), 0.1)
    weights = tmp / "net_g.pth"
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, weights)
    reset_launches()
    report, names = profiled(lambda: evaluate.main(
        ["-opt", str(cfg_path), "--checkpoint", str(weights)]))
    eval_counts = launches()
    n_val = report["num_items"]
    expect_launches(eval_counts, "path U evaluate", nafblk_a=36 * n_val,
                    nafblk_b=36 * n_val)
    expect_tensor_core_route(names, "path U evaluate")
    opt = parse(str(cfg_path), is_train=False)
    val_opt = opt["datasets"]["val"]
    load_weights(net, str(weights))
    direct = compute_metrics(
        make_eval_step(net),
        create_loader(create_dataset(val_opt), {**val_opt, "phase": "val"}),
        psf_kernel=evaluate.physics_kernel(opt).cuda(), use_lpips=True,
        lpips_net="vgg", device="cuda")
    got = report["metrics"]
    eval_diff = {k: abs(got[k] - direct[k]) for k in direct}
    check(set(got) == set(direct) and {"lpips", "phys_mae"} <= set(got)
          and n_val == U_PAIRS // 2
          and all(np.isfinite(v) for v in got.values())
          and all(d <= 1e-6 * max(1.0, abs(direct[k]))
                  for k, d in eval_diff.items()),
          f"path U evaluate {got} against compute_metrics {direct}")
    reset_launches()
    identity = evaluate.main(["-opt", str(cfg_path), "--identity"])
    expect_launches(launches(), "path U evaluate --identity")
    check(all(np.isfinite(v) for v in identity["metrics"].values()),
          f"path U evaluate --identity {identity}")
    if old_root is None:
        os.environ.pop("SID_ROOT")
    else:
        os.environ["SID_ROOT"] = old_root
    print(f"path U evaluate: {got}; |report - compute_metrics| "
          f"{max(eval_diff.values())}; 36 launches of K1 and K2 in each of "
          f"{n_val} forwards; --identity {identity['metrics']}")
    secs["evaluate"] = time.perf_counter() - t0

    # 3. profile_train at its defaults
    t0 = time.perf_counter()
    reset_launches()
    pt = profile_train.main([])
    pt_counts = launches()
    steps = sum(pt["calls"][k] for k in profile_train.LOSSES)
    fwd = pt["calls"]["fwd"] + pt["calls"]["gl1"] + steps
    bwd = pt["calls"]["gl1"] + steps
    expect_launches(pt_counts, "path U profile_train", nafblk_a=36 * fwd,
                    nafblk_b=36 * fwd, nafblk_p1=36 * bwd,
                    nafblk_p2=36 * bwd)
    check(all(np.isfinite(v) for v in pt["first_l_total"].values()),
          f"path U profile_train l_total {pt['first_l_total']}")
    _, names = profiled(lambda: profile_train.main(
        ["--only", "full", "--runs", "1"]))
    expect_tensor_core_route(names, "path U profile_train traced run",
                             backward=True)
    secs["profile_train"] = time.perf_counter() - t0

    # 4. profile_step_families
    t0 = time.perf_counter()
    fam = profile_step_families.main(["--top", "64"])
    families = list(fam["families_ms_per_step"])
    missing = [k for k in K12_TENSOR_CORES + K34_TENSOR_CORES
               if not any(k in f for f in families)]
    check(not missing, f"path U profile_step_families: no family names "
          f"{missing} in {families}")
    secs["profile_step_families"] = time.perf_counter() - t0

    # 5. debug_overfit (fp32: the FMA route at C = 8, 16, 32)
    t0 = time.perf_counter()
    reset_launches()
    overfit = debug_overfit.main(["--steps", str(OVERFIT_STEPS)])
    ov_counts = launches()
    per_run = OVERFIT_BLOCKS * (len(overfit["l1"]) + len(overfit["hybrid"]))
    expect_launches(ov_counts, "path U debug_overfit", nafblk_a=per_run,
                    nafblk_b=per_run, nafblk_p1=per_run, nafblk_p2=per_run)
    check(all(v[-1] < v[0] for v in overfit.values()),
          f"path U debug_overfit did not fall: "
          f"{ {k: (v[0], v[-1]) for k, v in overfit.items()} }")
    _, names = profiled(lambda: debug_overfit.run(
        "l1", 2, 32, torch.device("cuda")))
    wrong = [k for k in K12_TENSOR_CORES + K34_TENSOR_CORES if k in names]
    missing = [k for k in K12_FMA + K34_FMA if k not in names]
    check(not wrong and not missing, f"path U debug_overfit: FMA kernels "
          f"{missing} missing, tensor-core kernels {wrong} ran")
    secs["debug_overfit"] = time.perf_counter() - t0

    # 6. train_pipeline_e2e
    t0 = time.perf_counter()
    reset_launches()
    e2e = train_pipeline_e2e.main(["--steps", str(U_E2E_STEPS),
                                   "--workers", "2"])
    e2e_counts = launches()
    e2e_steps = 3 + min(U_E2E_STEPS, 60) + 2 + U_E2E_STEPS
    expect_launches(e2e_counts, "path U train_pipeline_e2e",
                    **{k: 36 * e2e_steps for k in
                       ("nafblk_a", "nafblk_b", "nafblk_p1", "nafblk_p2")})
    rates = ("host_only_steps_per_sec", "device_only_steps_per_sec",
             "end_to_end_steps_per_sec")
    check(all(e2e[k] > 0 for k in rates) and np.isfinite(e2e["l_total"]),
          f"path U train_pipeline_e2e {e2e}")
    secs["train_pipeline_e2e"] = time.perf_counter() - t0

    # 7. the two-worker loader into the device prefetcher
    t0 = time.perf_counter()
    train_ds = SonySIDDataset(
        str(manifest), subset="train", phase="train", patch_size=384,
        samples_per_pair=4,
        io_backend={"type": "pack",
                    "short_path": str(packs / "train_short.pack"),
                    "long_path": str(packs / "train_long.pack")})
    host = []

    def kept(batches):
        for b in batches:
            host.append(b)
            yield b

    fed = list(prefetch_to_device(kept(make_grain_loader(
        train_ds, 2, seed=SEED, num_epochs=1, worker_count=2)),
        device="cuda"))
    check(len(host) == 2 * U_PAIRS // 2 and all(
        isinstance(b["lq"], np.ndarray) and b["lq"].shape == (2, 384, 384, 3)
        and b["lq"].flags["C_CONTIGUOUS"] and isinstance(b["key"], list)
        and np.allclose(b["lq"], np.clip(
            b["short_raw"] * b["expo_ratio"][:, None, None, None], 0, 1),
            atol=1e-6) for b in host),
        "path U make_grain_loader: the batch contract")
    check(len(fed) == len(host) and all(
        d["lq"].is_cuda and tuple(d["lq"].shape) == (2, 3, 384, 384)
        and torch.equal(d["lq"].cpu(), torch.from_numpy(h["lq"]).permute(
            0, 3, 1, 2)) for d, h in zip(fed, host)),
        "path U make_grain_loader -> prefetch_to_device")
    secs["grain_loader"] = time.perf_counter() - t0

    # 8. the backend probe
    platform = probe_backend()
    check(platform == "cuda", f"path U probe_backend() = {platform!r}")
    shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "seconds": secs, "evaluate_metrics": got,
        "evaluate_max_abs_diff_vs_compute_metrics": max(eval_diff.values()),
        "evaluate_identity_metrics": identity["metrics"],
        "evaluate_launches": eval_counts,
        "profile_train": {k: pt[k] for k in (
            "forward_ms", "grad_l1_ms", "train_step_ms", "first_l_total",
            "calls")},
        "profile_train_launches": pt_counts,
        "step_families_ms_per_step": fam["ms_per_step"],
        "step_families_top": dict(list(
            fam["families_ms_per_step"].items())[:12]),
        "debug_overfit": {k: (v[0], v[-1]) for k, v in overfit.items()},
        "debug_overfit_launches": ov_counts,
        "train_pipeline_e2e": e2e, "train_pipeline_e2e_launches": e2e_counts,
        "grain_batches": len(fed), "probe_backend": platform}
    print("path_U " + json.dumps(out))
    return out


def summary(k: str, rows: list, launches_: int, unit: str) -> dict:
    """One kernels-line entry: times summed over the calls of one pass of
    ``unit`` (``blocks`` calls at each row's shape)."""
    tag, source, replaces = KERNELS[k]
    t_bytes = sum(r["blocks"] * r["bound_ms"] for r in rows
                  if r["bound_by"] == "bytes")
    t_ops = sum(r["blocks"] * r["bound_ms"] for r in rows
                if r["bound_by"] == "operations")
    lib = [r["blocks"] * r["library_ms"] for r in rows if "library_ms" in r]
    lib_dev = [r["blocks"] * r["library_device_ms"] for r in rows
               if isinstance(r.get("library_device_ms"), float)]
    split: dict = {}
    for r in rows:
        for name, t in r["device_split"].items():
            split[name] = split.get(name, 0.0) + r["blocks"] * t
    measured = all(r["device_split"] for r in rows)
    return {
        "name": k, "tag": tag, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches_,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["blocks"] * r["ms"] for r in rows),
        "device_ms": sum(split.values()) if measured else "not measured",
        "device_split": split,
        "library_device_ms": (sum(lib_dev) if len(lib_dev) == len(rows)
                              and lib_dev else None),
        "plain_ms": sum(r["blocks"] * r["plain_ms"] for r in rows),
        "bound_ms": t_bytes + t_ops,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(lib) if lib else None, "unit": unit,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)

    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.SIGNATURES:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows: dict = {}

    def phase(title: str, fn, *args):
        print(f"{title}:")
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{title}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("LayerNorm kernel phase (K5/K6)", ln_phase, gen, rows)
    phase("pool kernel phase (K7/K8)", pool_phase, gen, rows)
    phase("forward kernel phase (batch 2, serving widths and C=1024)",
          forward_phase, gen, rows)
    phase("backward kernel phase (batches 2 and 1, 384x384 training "
          "widths)",
          backward_phase, gen, rows)
    phase("narrow-channel phase (K1-K4 at C = 8, 24, 40, 12, 6, 10)",
          narrow_channels_phase, gen, rows)
    serve = phase("serving phase", serving_phase, gen)
    path_e = phase("path E (export_model and ExportedModel of "
                   "NewBPNAFNet)", export_path)
    tlc = phase("path C (NAFNetLocal, TLC)", tlc_path, gen)
    train = phase("training phase", training_phase)
    debug = phase("path D (the debug network in bf16)", debug_path)
    path_t = phase("path T (the Trainer on the flagship config)",
                   trainer_path, train["ms_per_step"])
    path_a = phase("path A (the Trainer on sid_nafnet_tpu, sid_unet, "
                   "sid_swinir)", architectures_path, path_t["ms_per_step"])
    cli = phase("CLI (train.py and test.py on the debug config)", cli_path)
    perc = phase("path P", perceptual_path)
    base = phase("path B", baseline_path)
    base_export = phase("path B export (Baseline through ExportedModel)",
                        baseline_export_path)
    ssr = phase("path S", nafssr_path)
    path_r = phase("path R (the Trainer, LowlightModel and demo_ssr on "
                   "stereo_nafssr)", stereo_trainer_path)
    flow = phase("video path on the card (flow_warp, duf_downsample)",
                 flow_device_check)
    path_m = phase("path M (the evaluation metrics)", evaluation_path)
    path_l = phase("path L (LPIPS in the loss)", lpips_loss_path,
                   train["ms_per_step"])
    par = phase("paths DP and SP (data-parallel training, ZeRO-1, the "
                "spatial forward, the two-rank Trainer)", parallel_path)
    trun = phase("torchrun CLI (a world of 1 on NCCL)", torchrun_cli_path)
    mesh_serve = phase("serving mesh and sharded export (one device)",
                       mesh_serving_path, gen)
    path_u = phase("path U (the user's tools, the two-worker loader, the "
                   "backend probe)", tools_path)

    kernels = []
    bf16 = lambda k: [r for r in rows[k] if r["dtype"] == "bfloat16"]
    on = lambda rs, path: [r for r in rs if r["path"] == path]

    def nafssr_keys(k):
        """The kernel's launches and fp32 times in one NAFSSR step."""
        fp32 = [r for r in rows[k] if r["dtype"] == "float32"]
        step = summary(k, on(fp32, "nafssr"), 0, "")
        return dict(nafssr_launches=ssr["launches"][k], nafssr_ms=step["ms"],
                    nafssr_device_ms=step["device_ms"],
                    nafssr_plain_ms=step["plain_ms"],
                    nafssr_bound_ms=step["bound_ms"],
                    nafssr_library_ms=step["library_ms"])

    def nafnet_tpu_keys(k):
        """The kernel's bf16 times in one NAFNetTPU training step: its
        trunk's blocks at each width, at the backward phase's shapes
        (TRAIN_PATH's C=64@192^2 ... 512@24^2 and TPU_BOTTOM)."""
        blocks = path_a["sid_nafnet_tpu"]["blocks_per_width"]
        trunk = [dict(r, blocks=blocks[r["c"]]) for r in bf16(k)
                 if (r["path"], r["c"]) in {("train", c) for c in blocks}
                 | {("nafnet_tpu", TPU_BOTTOM[1])}]
        check(sorted(r["c"] for r in trunk) == sorted(blocks),
              f"{k}: no row for every NAFNetTPU width")
        step = summary(k, trunk, 0, "")
        return dict(nafnet_tpu_ms=step["ms"],
                    nafnet_tpu_device_ms=step["device_ms"],
                    nafnet_tpu_plain_ms=step["plain_ms"],
                    nafnet_tpu_bound_ms=step["bound_ms"])

    def dp_keys(k):
        """The kernel's bf16 times in one step of a rank of path DP (one
        384x384 image, 36 blocks), at the backward phase's N=1 shapes."""
        step = summary(k, on(bf16(k), "dp"), 0, "")
        return dict(dp_launches=par["launches_per_step"][k],
                    dp_ms=step["ms"], dp_device_ms=step["device_ms"],
                    dp_plain_ms=step["plain_ms"],
                    dp_bound_ms=step["bound_ms"])

    for k in ("nafblk_a", "nafblk_b"):
        entry = summary(k, on(bf16(k), "serve"), serve["launches"][k],
                        "one 512x512 N=2 bf16 forward (36 blocks)")
        step = summary(k, on(bf16(k), "train"), 0, "")
        entry.update(train_launches=train["launches"][k],
                     train_ms=step["ms"], train_device_ms=step["device_ms"],
                     train_plain_ms=step["plain_ms"],
                     train_bound_ms=step["bound_ms"], **nafssr_keys(k),
                     **nafnet_tpu_keys(k), **dp_keys(k))
        kernels.append(entry)
    for k in ("nafblk_p1", "nafblk_p2"):
        entry = summary(k, on(bf16(k), "train"), train["launches"][k],
                        "one 384x384 N=2 bf16 training step (36 blocks)")
        entry.update(nafssr_keys(k), **nafnet_tpu_keys(k), **dp_keys(k))
        kernels.append(entry)
    for k in ("ln_fwd", "ln_bwd"):
        entry = summary(k, on(bf16(k), "baseline"), base["launches"][k],
                        "one Baseline-width32 384x384 N=2 bf16 training step "
                        "(72 LayerNorms)")
        entry.update(serve_launches=base["serve_launches"][k],
                     **nafssr_keys(k))
        if k == "ln_fwd":      # serving runs no backward
            fwd = summary(k, on(bf16(k), "baseline_serve"), 0, "")
            entry.update(serve_ms=fwd["ms"], serve_device_ms=fwd["device_ms"],
                         serve_library_device_ms=fwd["library_device_ms"],
                         serve_plain_ms=fwd["plain_ms"],
                         serve_bound_ms=fwd["bound_ms"],
                         serve_library_ms=fwd["library_ms"])
        kernels.append(entry)
    # per training step under kernel_fused the trunk runs on the prediction
    # and on the target (K7 twice per pool site) and backward once
    for k, passes in (("relu_pool_fwd", 2), ("pool_bwd", 1)):
        vgg = [dict(r, blocks=passes) for r in on(bf16(k), "vgg")]
        entry = summary(k, vgg, perc["kernel_fused"]["launches"][k],
                        "one 384x384 N=2 bf16 training step with "
                        "pool_impl=kernel_fused (4 pool sites)")
        entry.update(
            kernel_bwd_launches=perc["kernel_bwd"]["launches"][k])
        kernels.append(entry)
    # launches of each kernel by the path that made them: a serving run of
    # 8 requests, the timed training steps (3; path P's 2), or one step
    # (per_step) or one forward of the paths that drive the user's entry
    # points
    by_path = {
        "serve": serve["launches"], "train": train["launches"],
        "D_step": debug["launches"],
        "T_per_step": path_t["launches_per_step"],
        "P_kernel_fused": perc["kernel_fused"]["launches"],
        "P_kernel_bwd": perc["kernel_bwd"]["launches"],
        "B": base["launches"], "B_serve": base["serve_launches"],
        "S": ssr["launches"],
        "C_fused_forward": tlc["launches"]["fused"],
        "C_tlc_forward": tlc["launches"]["local"],
        **{f"A_{k}_per_step": v["launches_per_step"]
           for k, v in path_a.items()},
        "R_per_step": path_r["launches_per_step"],
        "E": path_e["launches_per_forward"],
        "B_export": base_export["launches_per_forward"],
        "L_per_step": path_l["launches_per_step"],
        "DP": par["launches_per_step"],
        "SP": par["sp_launches_per_forward"],
        "mesh_serve": mesh_serve["launches"],
        "mesh_export_per_forward":
            mesh_serve["export_launches_per_forward"],
        "U_evaluate": path_u["evaluate_launches"],
        "U_profile_train": path_u["profile_train_launches"],
        "U_debug_overfit": path_u["debug_overfit_launches"],
        "U_train_pipeline_e2e": path_u["train_pipeline_e2e_launches"]}
    for entry in kernels:
        entry["per_width"] = rows[entry["name"]]
        entry["path_launches"] = {p: c.get(entry["name"], 0)
                                  for p, c in by_path.items()
                                  if c.get(entry["name"], 0)}
    print(json.dumps({
        "kernels": kernels, "card": card,
        "train_ms_per_step": train["ms_per_step"],
        "device_busy_ms": {"train": train["device_busy_ms"],
                           "kernel_fused":
                               perc["kernel_fused"]["device_busy_ms"],
                           "kernel_bwd": perc["kernel_bwd"]["device_busy_ms"],
                           "baseline": base["device_busy_ms"],
                           "nafssr": ssr["device_busy_ms"]},
        # [kernel records, kernel launches] of each traced step: a busy
        # time is complete only where the two are equal
        "kernel_records": {"train": train["kernel_records"],
                           "kernel_fused":
                               perc["kernel_fused"]["kernel_records"],
                           "kernel_bwd": perc["kernel_bwd"]["kernel_records"],
                           "baseline": base["kernel_records"],
                           "nafssr": ssr["kernel_records"]},
        "train_device_top": train["device_top"],
        "serve_wall_s": serve["wall_s"],
        "kernel_fused_ms_per_step": perc["kernel_fused"]["ms_per_step"],
        "kernel_bwd_ms_per_step": perc["kernel_bwd"]["ms_per_step"],
        "baseline_ms_per_step": base["ms_per_step"],
        "baseline_serve_wall_s": base["serve_wall_s"],
        "baseline_serve_err": base["serve_err"],
        "nafssr_ms_per_step": ssr["ms_per_step"],
        "debug_step": {"launches": debug["launches"],
                       "l_total": debug["l_total"],
                       "device_busy_ms": debug["device_busy_ms"],
                       "kernel_records": debug["kernel_records"]},
        "path_T": {k: path_t[k] for k in (
            "ms_per_step", "data_ms_per_step", "iteration_ms", "val_wall_s",
            "val_metrics", "train_phase_ms_per_step")},
        "cli": cli,
        "path_M": {k: path_m[k] for k in (
            "metrics", "metric_wall_ms", "forward_ms_1x3x512",
            "lpips_vgg_ms_per_512_pair", "inception_ms_per_299_batch_of_2",
            "lpips_vgg_ms_1424x2128_pair", "inception_ms_1424x2128",
            "fp32_tflop_s")},
        "path_L": {k: path_l[k] for k in (
            "ms_per_step", "ratio_to_train_phase", "device_busy_ms",
            "device_idle_share", "l_lpips")},
        "path_A": {k: {kk: v[kk] for kk in (
            "ms_per_step", "data_ms_per_step", "device_busy_ms",
            "device_idle_share", "kernel_records", "val_metrics", "test",
            "path_T_ms_per_step")} for k, v in path_a.items()},
        "path_C": {k: tlc[k] for k in (
            "err_vs_fused", "local_vs_global_max_abs", "forward_ms")},
        "path_R": {k: path_r[k] for k in (
            "ms_per_step", "data_ms_per_step", "device_busy_ms",
            "device_idle_share", "kernel_records", "val_metrics",
            "wrapper_logs", "defilter")},
        "path_E": path_e, "path_B_export": base_export,
        "flow_card_vs_cpu": flow, "path_DP_SP": par, "torchrun": trun,
        "mesh_serving": mesh_serve, "path_U": path_u}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
