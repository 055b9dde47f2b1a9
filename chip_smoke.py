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
   after warm-up) beside the bound from bytes and FLOPs;
4. backward kernel phase: the same for K1, K2, K3 (``nafblk_p1``), K4
   (``nafblk_p2``) and the whole block backward (``NAFBlockFunction`` vs
   the plain backward) at every width of a 384x384, N=2 training crop
   (C=32@384^2 ... C=512@24^2), at the width-64 configuration's
   C=1024@32^2 and at C=64@20^2 (a side that leaves K4 ragged edge
   tiles), checking dz, da, dx and every weight grad;
5. serving phase: ``RestorationServer`` on ``NewBPNAFNet`` (width 32,
   full depth: 36 NAFBlocks) in bf16 with seeded random weights answers 8
   mixed-size requests (one through the tiled path); checks shapes,
   finiteness, that every NAFBlock forward went through K1+K2 (launch
   counts), and one request against the model's eager (plain) path;
6. training phase: the train step of ``configs/sid_newbp_mono_selfcontained
   .yml`` (``NewBPNAFNet`` in bf16, ``HybridLossPlus`` with the random
   bf16 VGG19 trunk, AdamW + clip 0.01 on the cosine schedule) on one
   seeded synthetic 2x3x384x384 batch: 1 warm-up and 5 timed steps;
   checks finite logs, 36 launches of each of K1-K4 per step, a falling
   loss, fp32 gradients through the kernels against the eager block path,
   and one eval forward.

Any failed check raises, so the script exits non-zero. It prints a JSON
line ``{"kernels": [...]}`` and the card line before the last line, and
as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
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
# |kernel - plain| <= TOL * max|plain|: fp32 differs only by summation
# order; bf16 allows 4 bf16 ulps at the top of the range (a rounding of
# an operand or of the stored result may land on the other side).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
SERVE_SHAPES = [(512, 512)] * 4 + [(600, 400)] * 2 + [(256, 384),
                                                      (1500, 1000)]
TRAIN_CONFIG = Path(__file__).resolve().parent / "configs" / \
    "sid_newbp_mono_selfcontained.yml"
TRAIN_STEPS = 5
PALLAS = "lowlight_image_enhancement_tpu/ops/pallas/nafblock.py"
CSRC = "lowlight_image_enhancement_tpu_torch/csrc/"
KERNELS = {
    "nafblk_a": ("K1", CSRC + "nafblock_fwd.cu", PALLAS + ":462"),
    "nafblk_b": ("K2", CSRC + "nafblock_fwd.cu", PALLAS + ":534"),
    "nafblk_p1": ("K3", CSRC + "nafblock_bwd.cu", PALLAS + ":579"),
    "nafblk_p2": ("K4", CSRC + "nafblock_bwd.cu", PALLAS + ":698"),
}
WRAPPERS = {"nafblk_a": ops.call_a, "nafblk_b": ops.call_b,
            "nafblk_p1": ops.call_p1, "nafblk_p2": ops.call_p2}


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


def bound(kind: str, c: int, hw: int, dt: torch.dtype):
    """Least time (ms) for one call's work: bytes (each input read once,
    each output written once) over the HBM rate vs the FLOPs of its
    matrix products (F = C) over the operand type's peak."""
    s = torch.tensor([], dtype=dt).element_size()
    act = BATCH * c * hw
    px = BATCH * hw
    nc = 4 * BATCH * c                        # one [N, C] fp32 array
    if kind == "nafblk_a":     # x in, g out; W1, kdw, vectors; sums out
        nbytes = 2 * act * s + 4 * (2 * c * c + 18 * c + 6 * c) + nc
        flops = px * (4 * c * c + 36 * c)
    elif kind == "nafblk_b":   # x, g in, out; W3, W4, W5, vectors; att
        nbytes = 3 * act * s + 4 * (4 * c * c + 8 * c) + nc
        flops = px * 8 * c * c     # conv3 2C^2, conv4 4C^2, conv5 2C^2
    elif kind == "nafblk_p1":  # x, g, dout in, dz out; W3-W5, vectors;
        # att in, da out; fp32 grads of W3-W5 and 8 vectors out
        nbytes = 4 * act * s + 2 * 4 * (4 * c * c + 8 * c) + 2 * nc
        flops = px * 24 * c * c  # 8 C^2 recompute, 8 input-side, 8 wgrad
    else:                      # x, dz in, dx out; dgc, att in; W1, W3,
        # kdw and 7 vectors in (3C^2 + 25C); fp32 grads of W1, the 11 x 2C
        # taps (kdw, bk, b1) and w1n, b1n out (2C^2 + 24C)
        nbytes = 3 * act * s + 4 * (5 * c * c + 49 * c) + 2 * nc
        flops = px * (14 * c * c + 108 * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def report(kind, rows, c, side, dt, blocks, e, t_k, t_p, path):
    b_ms, b_by = bound(kind, c, side * side, dt)
    rows.setdefault(kind, []).append(dict(
        path=path, c=c, side=side, dtype=str(dt)[6:], blocks=blocks, err=e,
        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by))
    print(f"  C={c:4d} {side}x{side} {str(dt)[6:]:8s} {kind}: kernel "
          f"{t_k:.4f} ms  plain {t_p:.4f} ms  bound {b_ms:.4f} ms ({b_by})")


def show(checks, c, side, dt):
    tol = TOL[dt]
    for name, (e, rel) in checks.items():
        print(f"  C={c:4d} {side}x{side} {str(dt)[6:]:8s} {name:14s} "
              f"max_abs={e:.3e} rel={rel:.3e} tol={tol:.1e}")
        check(rel <= tol, f"{name} C={c} {dt}: rel {rel} > {tol}")


def forward_phase(gen: torch.Generator, rows: dict) -> None:
    widths = [(c, s, n, "serve") for c, s, n in MAIN_PATH]
    widths.append((*WIDE, 0, "w64"))
    for c, side, nblk, path in widths:
        hw = side * side
        blk = NAFBlock(c).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        x32 = torch.randn((BATCH, c, hw), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            with torch.no_grad():
                g_k, sums_k = ops.call_a(x, p, (side, side))
                g_p, sums_p = ops.plain_a(x, p, (side, side))
                att = ops.sca_attention(sums_p, p, hw)
                out_k = ops.call_b(x, g_p, att, p)
                out_p = ops.plain_b(x, g_p, att, p)
                blk_k = ops.nafblock_fwd(x, p, (side, side))
                blk_p = ops.nafblock_fwd_reference(x, p, (side, side))
            torch.cuda.synchronize()
            gmax = g_p.float().abs().max().item()
            checks = {
                "nafblk_a": err(g_k, g_p),
                "sca_mean": err(sums_k / hw, sums_p / hw, scale=gmax),
                "nafblk_b": err(out_k, out_p),
                "block": err(blk_k, blk_p),
            }
            show(checks, c, side, dt)
            with torch.no_grad():
                t = {
                    "nafblk_a": (
                        time_ms(lambda: ops.call_a(x, p, (side, side))),
                        time_ms(lambda: ops.plain_a(x, p, (side, side)))),
                    "nafblk_b": (
                        time_ms(lambda: ops.call_b(x, g_p, att, p)),
                        time_ms(lambda: ops.plain_b(x, g_p, att, p))),
                }
            for k, (t_k, t_p) in t.items():
                report(k, rows, c, side, dt, nblk, checks[k][0], t_k, t_p,
                       path)
        del blk, x32


def backward_phase(gen: torch.Generator, rows: dict) -> None:
    widths = [(c, s, n, "train") for c, s, n in TRAIN_PATH]
    widths += [(*WIDE, 0, "w64"), (*RAGGED, 0, "ragged")]
    for c, side, nblk, path in widths:
        hw = side * side
        shw = (side, side)
        blk = NAFBlock(c).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        x32 = torch.randn((BATCH, c, hw), generator=gen, device="cuda")
        d32 = torch.randn((BATCH, c, hw), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x, dout = x32.to(dt), d32.to(dt)
            checks = {}
            with torch.no_grad():
                g_k, _ = ops.call_a(x, p, shw)
                g, sums = ops.plain_a(x, p, shw)
                att = ops.sca_attention(sums, p, hw)
                m = sums / hw
                out_k = ops.call_b(x, g, att, p)
                out_p = ops.plain_b(x, g, att, p)
                dz_k, da_k, gk = ops.call_p1(x, g, dout, att, p)
                dz, da, gp = ops.plain_p1(x, g, dout, att, p)
                dwsca, dbsca, dgc = ops.sca_backward(da, m, p, hw)
                dx_k, g1k = ops.call_p2(x, dz, dgc, att, p, shw)
                dx, g1p = ops.plain_p2(x, dz, dgc, att, p, shw)
            torch.cuda.synchronize()
            checks["nafblk_a"] = err(g_k, g)
            checks["nafblk_b"] = err(out_k, out_p)
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
            show(checks, c, side, dt)
            with torch.no_grad():
                t = {
                    "nafblk_a": (time_ms(lambda: ops.call_a(x, p, shw)),
                                 time_ms(lambda: ops.plain_a(x, p, shw))),
                    "nafblk_b": (time_ms(lambda: ops.call_b(x, g, att, p)),
                                 time_ms(lambda: ops.plain_b(x, g, att, p))),
                    "nafblk_p1": (
                        time_ms(lambda: ops.call_p1(x, g, dout, att, p)),
                        time_ms(lambda: ops.plain_p1(x, g, dout, att, p))),
                    "nafblk_p2": (
                        time_ms(lambda: ops.call_p2(x, dz, dgc, att, p,
                                                    shw)),
                        time_ms(lambda: ops.plain_p2(x, dz, dgc, att, p,
                                                     shw))),
                }
            for k, (t_k, t_p) in t.items():
                report(k, rows, c, side, dt, nblk, checks[k][0], t_k, t_p,
                       path)
        del blk, x32, d32


def serving_phase(gen: torch.Generator) -> dict:
    net = define_network({"type": "NewBPNAFNet", "dtype": "bfloat16"},
                         device="cuda")
    check(len(net.blocks()) == 36, "NewBPNAFNet must hold 36 NAFBlocks")
    randomize_(net, gen, 0.1)
    server = RestorationServer(net, device="cuda")
    rng = np.random.default_rng(SEED)
    images = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
              for h, w in SERVE_SHAPES]
    server.predict(images[:1])             # warm-up (cuDNN, allocator)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
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
    for k in ("nafblk_a", "nafblk_b"):
        check(counts[k] == 36 * batches,
              f"{k}: {counts[k]} launches for {batches} batches")
    for k in ("nafblk_p1", "nafblk_p2"):
        check(counts[k] == 0, f"{k} launched {counts[k]} times serving")
    print(f"serving: {len(images)} requests in {wall:.3f} s "
          f"({wall / len(images) * 1e3:.1f} ms/request), {batches} forward "
          f"batches, launches {counts}")

    # the same request on the model's plain (eager) path on the card
    probe = SERVE_SHAPES.index((256, 384))
    res = {}
    for dt, tol in ((torch.bfloat16, 0.1), (torch.float32, 1e-3)):
        net.dtype = dt
        fused = server.predict([images[probe]])[0]
        for b in net.blocks():
            b.fused = False
        plain = server.predict([images[probe]])[0]
        for b in net.blocks():
            b.fused = True
        e = float(np.abs(fused - plain).max())
        scale = float(np.abs(plain).max())
        print(f"serving vs eager path, {str(dt)[6:]}: max_abs={e:.3e} "
              f"max|ref|={scale:.3e} tol={tol:.1e} * max(1, max|ref|)")
        check(e <= tol * max(1.0, scale), f"served {dt} output off eager path")
        res[str(dt)[6:]] = e
    return {"launches": counts, "wall_s": wall, "eager_err": res}


def training_phase() -> dict:
    opt = parse(str(TRAIN_CONFIG), is_train=True)
    train = opt["train"]
    amp = bool(train.get("enable_amp"))
    net = define_network({**opt["network_g"],
                          "dtype": "bfloat16" if amp else "float32"},
                         device="cuda")
    check(len(net.blocks()) == 36, "NewBPNAFNet must hold 36 NAFBlocks")
    # residual scales 0.01: the blocks start near the identity that
    # NAFNet's zero init of beta/gamma gives, yet every kernel gradient is
    # nonzero (at 0.1 the first AdamW steps overshoot and the loss bumps)
    randomize_(net, torch.Generator(device="cuda").manual_seed(SEED), 0.01)
    loss = build_hybrid_loss(train, device="cuda")
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
    step = make_train_step(net, loss, optimizer)

    # one seeded synthetic batch of the recipe's shape (2 x 384^2 crops)
    rng = np.random.default_rng(SEED)
    gt = rng.uniform(0, 1, (BATCH, 3, 384, 384)).astype(np.float32)
    expo = np.array([100.0, 300.0], np.float32)
    lq = np.clip(gt / expo[:, None, None, None]
                 + rng.normal(0, 1e-3, gt.shape), 0, 1).astype(np.float32)
    batch = {"lq": torch.from_numpy(lq).cuda(),
             "gt": torch.from_numpy(gt).cuda(),
             "expo_ratio": torch.from_numpy(expo).cuda()}

    state, logs0 = step(state, batch)             # warm-up
    assert_finite_logs(logs0)
    torch.cuda.synchronize()
    times, history, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, logs = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = launches()
        assert_finite_logs(logs)
        history.append({k: float(v) for k, v in logs.items()})
        per_step.append(counts)
        for k, n in counts.items():
            check(n == 36, f"{k}: {n} launches in one training step")
    l0, l5 = float(logs0["l_total"]), history[-1]["l_total"]
    print(f"training: {TRAIN_STEPS} steps, ms/step median "
          f"{statistics.median(times):.1f} (all {[round(t, 1) for t in times]})"
          f", l_total {l0:.6f} -> {l5:.6f}, launches/step {per_step[-1]}")
    for i, h in enumerate(history):
        print(f"  step {state.step - TRAIN_STEPS + i}: "
              + " ".join(f"{k}={v:.6g}" for k, v in h.items()))
    check(l5 < l0, f"l_total did not fall: {l0} -> {l5}")

    # fp32 gradients through the kernels vs the eager block path
    net.dtype = torch.float32
    loss.perceptual.vgg.dtype = torch.float32
    params = list(net.parameters())
    names = [k for k, _ in net.named_parameters()]

    def grads():
        out = net(batch["lq"])
        total, _ = loss(**hybrid_batch_kwargs(out, batch))
        return torch.autograd.grad(total, params)

    ops.reset_launch_counts()
    g_kernel = grads()
    check(ops.call_p1.launches == 36 and ops.call_p2.launches == 36,
          "fp32 check did not run the backward kernels")
    for b in net.blocks():
        b.fused = False
    g_eager = grads()
    for b in net.blocks():
        b.fused = True
    # each leaf against its own scale: |kernel - eager| <= 1e-3 * max|g|
    # of that leaf (1e-30 only lets a leaf whose gradient is exactly 0
    # in both pass)
    readings = []
    for k, gk, ge in zip(names, g_kernel, g_eager):
        gmax = ge.abs().max().item()
        d = (gk - ge).abs().max().item()
        readings.append((d / max(1e-3 * gmax, 1e-30), k, d, gmax))
    readings.sort(reverse=True)
    print(f"fp32 gradients, kernels vs eager blocks: {len(names)} leaves, "
          f"limit 1e-3 * max|g_eager| per leaf; worst five:")
    for frac, k, d, gmax in readings[:5]:
        print(f"  {k}: max_abs={d:.3e} max|g_eager|={gmax:.3e} "
              f"({frac:.3e} of its limit)")
    smallest = min(readings, key=lambda r: r[3])
    print(f"  smallest max|g_eager|: {smallest[1]} {smallest[3]:.3e}")
    for frac, k, d, gmax in readings:
        check(frac <= 1.0, f"fp32 grad {k}: |kernel - eager| {d} > 1e-3 * "
              f"{gmax}")
    worst = readings[0]
    net.dtype = torch.bfloat16 if amp else torch.float32
    loss.perceptual.vgg.dtype = torch.bfloat16 if amp else torch.float32

    ops.reset_launch_counts()
    out = make_eval_step(net)(batch["lq"])
    torch.cuda.synchronize()
    counts = launches()
    check(out.shape == batch["lq"].shape and bool(torch.isfinite(out).all()),
          "eval forward: bad output")
    check(counts == {"nafblk_a": 36, "nafblk_b": 36, "nafblk_p1": 0,
                     "nafblk_p2": 0}, f"eval forward launches {counts}")
    return {"ms_per_step": statistics.median(times), "step_ms": times,
            "l_total": [l0] + [h["l_total"] for h in history],
            "launches": {k: sum(c[k] for c in per_step) for k in WRAPPERS},
            "launches_per_step": per_step[-1],
            "grad_check_worst": worst[0]}


def summary(k: str, rows: list, launches_: int, unit: str) -> dict:
    """One kernels-line entry: bf16 times summed over the blocks of one
    pass of ``unit``."""
    tag, source, replaces = KERNELS[k]
    t_bytes = sum(r["blocks"] * r["bound_ms"] for r in rows
                  if r["bound_by"] == "bytes")
    t_ops = sum(r["blocks"] * r["bound_ms"] for r in rows
                if r["bound_by"] == "operations")
    return {
        "name": k, "tag": tag, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches_,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["blocks"] * r["ms"] for r in rows),
        "plain_ms": sum(r["blocks"] * r["plain_ms"] for r in rows),
        "bound_ms": t_bytes + t_ops,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "unit": unit,
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
    print("forward kernel phase (batch 2, serving widths and C=1024):")
    forward_phase(gen, rows)
    print("backward kernel phase (batch 2, 384x384 training widths):")
    backward_phase(gen, rows)
    serve = serving_phase(gen)
    train = training_phase()

    kernels = []
    for k in KERNELS:
        bf16 = [r for r in rows[k] if r["dtype"] == "bfloat16"]
        if k in ("nafblk_a", "nafblk_b"):
            entry = summary(k, [r for r in bf16 if r["path"] == "serve"],
                            serve["launches"][k],
                            "one 512x512 N=2 bf16 forward (36 blocks)")
            step = summary(k, [r for r in bf16 if r["path"] == "train"],
                           0, "")
            entry.update(train_launches=train["launches"][k],
                         train_ms=step["ms"], train_plain_ms=step["plain_ms"],
                         train_bound_ms=step["bound_ms"])
        else:
            entry = summary(k, [r for r in bf16 if r["path"] == "train"],
                            train["launches"][k],
                            "one 384x384 N=2 bf16 training step (36 blocks)")
        entry["per_width"] = rows[k]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "card": card,
                      "train_ms_per_step": train["ms_per_step"],
                      "serve_wall_s": serve["wall_s"]}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
