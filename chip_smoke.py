#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives ``lowlight_image_enhancement_tpu_torch`` only (no JAX):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``lowlight_image_enhancement_tpu_torch/
   csrc`` (nvcc, one process per source, all started together);
3. kernel phase: holds K1 (``nafblk_a``), K2 (``nafblk_b``) and the whole
   block K1 -> SCA -> K2 against their plain PyTorch versions on the card,
   at every main-path width of a 512x512, N=2 forward (C=32@512^2 ...
   C=512@32^2), in fp32 and bf16, and times kernel and plain version
   (CUDA events, median after warm-up) beside the bound from bytes and
   FLOPs;
4. serving phase: ``RestorationServer`` on ``NewBPNAFNet`` (width 32,
   full depth: 36 NAFBlocks) in bf16 with seeded random weights answers 8
   mixed-size requests (one through the tiled path); checks shapes,
   finiteness, that every NAFBlock forward went through K1+K2 (launch
   counts), and one request against the model's eager (plain) path.

Any failed check raises, so the script exits non-zero. It prints a JSON
line ``{"kernels": [...]}`` before the last line, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFBlock
from lowlight_image_enhancement_tpu_torch.ops import _build
from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
from lowlight_image_enhancement_tpu_torch.serving import RestorationServer

SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s by operand type (bf16 on the tensor cores, fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (C, side, NAFBlocks at this width in one NewBPNAFNet forward): enc
# (2,2,4,8), 12 middle, dec (2,2,2,2) on a 512x512 input
MAIN_PATH = [(32, 512, 4), (64, 256, 4), (128, 128, 6), (256, 64, 10),
             (512, 32, 12)]
BATCH = 2
# |kernel - plain| <= TOL * max|plain|: fp32 differs only by summation
# order; bf16 allows 4 bf16 ulps at the top of the range (a rounding of
# an operand or of the stored result may land on the other side).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
SERVE_SHAPES = [(512, 512)] * 4 + [(600, 400)] * 2 + [(256, 384),
                                                      (1500, 1000)]
KERNELS = {
    "nafblk_a": ("K1", "lowlight_image_enhancement_tpu/ops/pallas/"
                 "nafblock.py:462"),
    "nafblk_b": ("K2", "lowlight_image_enhancement_tpu/ops/pallas/"
                 "nafblock.py:534"),
}
SOURCE = "lowlight_image_enhancement_tpu_torch/csrc/nafblock_fwd.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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
    """Least time (ms) for the work: bytes (each input read once, each
    output written once) over HBM rate vs FLOPs over the type's peak."""
    s = torch.tensor([], dtype=dt).element_size()
    act = BATCH * c * hw
    if kind == "nafblk_a":       # x in, g out; W1, kdw, vectors; sums
        nbytes = 2 * act * s + 4 * (2 * c * c + 18 * c + 6 * c) \
            + 4 * BATCH * c
        flops = 2 * BATCH * hw * (2 * c * c + 9 * 2 * c)
    else:                        # x, g in, out; W3, W4, W5, vectors; att
        nbytes = 3 * act * s + 4 * (4 * c * c + 8 * c) + 4 * BATCH * c
        flops = 2 * BATCH * hw * (c * c + 2 * c * c + c * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def kernel_phase(gen: torch.Generator) -> dict:
    rows = {k: [] for k in KERNELS}
    for c, side, nblk in MAIN_PATH:
        hw = side * side
        blk = NAFBlock(c).cuda()
        randomize_(blk, gen, 1.0)
        p = blk.packed()
        x32 = torch.randn((BATCH, c, hw), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            tol = TOL[dt]
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
            for name, (e, rel) in checks.items():
                print(f"  C={c:3d} {side}x{side} {str(dt)[6:]:8s} {name:8s} "
                      f"max_abs={e:.3e} rel={rel:.3e} tol={tol:.1e}")
                check(rel <= tol, f"{name} C={c} {dt}: rel {rel} > {tol}")
            with torch.no_grad():
                t = {
                    "nafblk_a": (
                        time_ms(lambda: ops.call_a(x, p, (side, side))),
                        time_ms(lambda: ops.plain_a(x, p, (side, side)))),
                    "nafblk_b": (
                        time_ms(lambda: ops.call_b(x, g_p, att, p)),
                        time_ms(lambda: ops.plain_b(x, g_p, att, p))),
                }
            for k in KERNELS:
                b_ms, b_by = bound(k, c, hw, dt)
                rows[k].append(dict(c=c, side=side, dtype=str(dt)[6:],
                                    blocks=nblk, err=checks[k][0],
                                    ms=t[k][0], plain_ms=t[k][1],
                                    bound_ms=b_ms, bound_by=b_by))
                print(f"  C={c:3d} {side}x{side} {str(dt)[6:]:8s} {k}: "
                      f"kernel {t[k][0]:.4f} ms  plain {t[k][1]:.4f} ms  "
                      f"bound {b_ms:.4f} ms ({b_by})")
        del blk, x32
    return rows


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
    launches = {"nafblk_a": ops.call_a.launches,
                "nafblk_b": ops.call_b.launches}
    batches = server.forward_batches

    for im, out in zip(images, outs):
        check(out.shape == im.shape, f"output {out.shape} for {im.shape}")
        check(bool(np.isfinite(out).all()), f"non-finite output {im.shape}")
    check(batches == 4, f"expected 4 forward batches, ran {batches}")
    for k, n in launches.items():
        check(n == 36 * batches, f"{k}: {n} launches for {batches} batches")
    print(f"serving: {len(images)} requests in {wall:.3f} s "
          f"({wall / len(images) * 1e3:.1f} ms/request), {batches} forward "
          f"batches, launches {launches}")

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
    net.dtype = torch.bfloat16
    return {"launches": launches, "wall_s": wall, "eager_err": res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    print("kernel phase (batch 2, main-path widths):")
    rows = kernel_phase(gen)
    serve = serving_phase(gen)

    kernels = []
    for k, (tag, replaces) in KERNELS.items():
        main = [r for r in rows[k] if r["dtype"] == "bfloat16"]
        t_bytes = sum(r["blocks"] * r["bound_ms"] for r in main
                      if r["bound_by"] == "bytes")
        t_ops = sum(r["blocks"] * r["bound_ms"] for r in main
                    if r["bound_by"] == "operations")
        kernels.append({
            "name": k, "tag": tag, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": serve["launches"][k],
            "max_abs_err": max(r["err"] for r in main),
            # one 512x512 N=2 bf16 forward: sum over its 36 blocks
            "ms": sum(r["blocks"] * r["ms"] for r in main),
            "plain_ms": sum(r["blocks"] * r["plain_ms"] for r in main),
            "bound_ms": t_bytes + t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "per_width": rows[k],
        })
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
