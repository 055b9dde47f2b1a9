"""Serving cells: one closed-loop client calling ``RestorationServer.predict``.

Each call sends ``images_per_call`` images of ``height x width`` drawn
from a seeded pool (every seed the same sizes, another order); the next
call starts when the previous one's outputs are on the host. A reservoir,
drawn from the seed, keeps the inputs and outputs of ``sample_calls``
calls of the window for the check.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from port_bench.harness import trace as tr_mod
from port_bench.harness.data import image_pool
from port_bench.harness.record import Hooks, Run, Unit, log
from port_bench.harness.weights import make_params, subseed
from port_bench.reference.ops import fp8_round
from port_bench.reference.serve import restore_call

SPANS = ("server.predict", "model.forward", "tiling")


class Reservoir:
    """``k`` items, each offered item kept with equal chance."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items = k, rng, []

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = item


def net_params(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights of ``cell``'s network, by its reference's
    ``param_shapes`` (and ``init``, where it has one)."""
    cfg, ref = cell.config, cell.reference
    return make_params(
        ref.param_shapes(cfg["network_g"]), seed, "net", device,
        residual_scale=cfg.get("assumed", {}).get("residual_scale"),
        init=getattr(ref, "init", None))


def reference_forward(cell, params, quant=None):
    ref, net = cell.reference, cell.config["network_g"]

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return ref.forward(x, params, net, quant)
    return forward


def out_gap(forward, sample, pool, server: dict, device) -> float:
    """Worst over the sampled images of ``|out - ref| / |ref - in|``
    (L2 over the image): the served output's distance from the
    reference's, against what the network adds to its input."""
    worst = 0.0
    for idx, outs in sample:
        imgs = [torch.from_numpy(pool[j]).to(device).permute(2, 0, 1)
                for j in idx]
        refs = restore_call(forward, imgs, server)
        for img, ref, out in zip(imgs, refs, outs):
            if out is None or tuple(out.shape) != tuple(img.permute(
                    1, 2, 0).shape):
                return float("inf")
            got = torch.from_numpy(np.asarray(out)).to(device).permute(
                2, 0, 1)
            gap = float((got - ref).norm() / (ref - img).norm())
            worst = max(worst, gap)
    return worst


def run_serve(cell, seed: int, seconds: float, trace: bool, device, t0: float,
              tmpdir: str):
    from lowlight_image_enhancement_tpu_torch.models import define_network
    from lowlight_image_enhancement_tpu_torch.serving import (
        RestorationServer,
    )

    cfg, traffic = cell.config, cell.traffic
    server_opt = traffic["server"]
    run = Run("serve", cfg["dtype"], cfg["network_g"], cell.reference)
    pool = image_pool(traffic["pool"], traffic["height"], traffic["width"],
                      seed, device)
    log("inputs made")
    net = define_network(dict(cfg["network_g"], dtype=cfg["dtype"]),
                         device=device)
    net.load_state_dict(net_params(cell, seed, device))
    server = RestorationServer(net, device=device, **server_opt)
    spans = tr_mod.Spans(on=False)
    hooks = Hooks(net, run, spans) if trace else None
    tiled = server._predict_tiled

    def predict_tiled(img):
        spans.enter("tiling")
        try:
            return tiled(img)
        finally:
            spans.exit("tiling")
    server._predict_tiled = predict_tiled

    rng = np.random.default_rng(subseed(seed, "calls"))
    per_call = traffic["images_per_call"]
    px = per_call * traffic["height"] * traffic["width"]

    def call():
        idx = [int(j) for j in rng.choice(len(pool), per_call,
                                          replace=False)]
        spans.enter("server.predict")
        a = time.perf_counter()
        outs = server.predict([pool[j] for j in idx])
        b = time.perf_counter()
        spans.exit("server.predict")
        return idx, outs, Unit(a, b, px)

    log("server built")
    for _ in range(traffic["warmup_calls"]):
        call()
    if device != "cpu":
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t0

    keep = Reservoir(traffic["sample_calls"],
                     np.random.default_rng(subseed(seed, "sample")))
    failed = 0
    if hooks:
        hooks.counting = True
    t_open = time.perf_counter()
    while True:
        idx, outs, unit = call()
        run.units.append(unit)
        failed += sum(o is None or o.shape != pool[j].shape
                      for j, o in zip(idx, outs))
        keep.offer(len(run.units) - 1, (idx, outs))
        if unit.end - t_open >= seconds:
            break
    run.window_s = run.units[-1].end - run.units[0].start
    if hooks:
        hooks.counting = False
        path = os.path.join(tmpdir, "trace.json")
        prof = tr_mod.Profiler(path)
        prof.start()
        spans.on = True
        spans.enter(tr_mod.WINDOW)
        hooks.tracing = True
        for _ in range(traffic["traced_calls"]):
            run.traced.append(call()[2])
        if device != "cpu":
            torch.cuda.synchronize()
        spans.exit(tr_mod.WINDOW)
        spans.on = hooks.tracing = False
        prof.stop()
        run.trace = tr_mod.read_trace(path, SPANS)
        os.remove(path)
        hooks.remove()
    if device != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    sample = keep.items
    del server, net, hooks
    if device != "cpu":
        torch.cuda.empty_cache()

    def check() -> Dict[str, float]:
        fwd = reference_forward(cell, net_params(cell, seed, device))
        return {"out_gap": out_gap(fwd, sample, pool, server_opt, device)}
    return run, len(run.units), failed, check


def control_readings(cell, seed: int, device) -> Dict[str, float]:
    """The control: the reference in fp8 put in the program's place, on
    the calls of a window's first ``sample_calls`` draws, judged as the
    program is."""
    traffic = cell.traffic
    pool = image_pool(traffic["pool"], traffic["height"], traffic["width"],
                      seed, device)
    params = net_params(cell, seed, device)
    rng = np.random.default_rng(subseed(seed, "calls"))
    ctrl = reference_forward(cell, params, fp8_round)
    sample = []
    for _ in range(traffic["sample_calls"]):
        idx = [int(j) for j in rng.choice(len(pool),
                                          traffic["images_per_call"],
                                          replace=False)]
        imgs = [torch.from_numpy(pool[j]).to(device).permute(2, 0, 1)
                for j in idx]
        outs = [o.permute(1, 2, 0).cpu().numpy()
                for o in restore_call(ctrl, imgs, traffic["server"])]
        sample.append((idx, outs))
    fwd = reference_forward(cell, params)
    return {"out_gap": out_gap(fwd, sample, pool, traffic["server"], device)}
