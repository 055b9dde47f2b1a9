"""Training cells: the configuration's recipe through ``Trainer(opt).train()``.

Set-up writes the seeded SID packs, builds the Trainer, loads the seeded
weights into its network and perceptual trunk, and wraps its ``step_fn``.
The wrapped step drives the run: steps 1-3 are the checked steps (their
batches and losses are kept, and the first step's network output; at
step 2 the optimizer's first moment gives the first clipped gradient; at
step 4 the parameters' change after three updates is read; both are
kept on the host, leaf by leaf), ``warmup_steps`` more follow, then the
measured window of ``--seconds``, then, with ``--trace 1``,
``traced_steps`` under the profiler; the wrapper then lowers the
Trainer's ``total_iters`` so that its loop ends. Every step goes through
the Trainer's own loop, loader and prefetcher.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import trace as tr_mod
from port_bench.harness.data import (
    CropFinder,
    sid_pairs,
    sub_images,
    write_sid_root,
)
from port_bench.harness.record import Hooks, Run, Unit, log
from port_bench.harness.serve import net_params
from port_bench.harness.weights import make_params, subseed
from port_bench.reference.loss import loss_weights, newbp_loss, vgg_shapes
from port_bench.reference.ops import fp8_round
from port_bench.reference.optim import AdamWClip

SPANS = ("train.step", "trainer.data", "model.forward")
CHECKED = 3


def make_pairs(traffic: dict, seed: int, device):
    d = traffic["data"]
    pairs = sid_pairs(d["frames"], d["height"], d["width"], d["ratios"],
                      seed, device)
    if "sub_image" in d:
        pairs = sub_images(pairs, d["sub_image"], d["sub_step"])
        pick = np.random.default_rng(subseed(seed, "sub_images")).choice(
            len(pairs), d["sub_images"], replace=False)
        pairs = [pairs[i] for i in sorted(pick)]
    return pairs


def trainer_opt(cfg: dict, traffic: dict, paths: dict, seed: int) -> dict:
    train = dict(cfg["train"], total_iter=10 ** 9)
    return {
        "name": "port_bench", "model_type": "ImageRestorationModel",
        "scale": 1, "manual_seed": subseed(seed, "manual_seed", bits=31),
        "network_g": cfg["network_g"], "train": train,
        "datasets": {"train": {
            "name": "SID-train", "type": "SonySIDDataset", "phase": "train",
            "subset": "train", "manifest_path": paths["manifest_path"],
            "io_backend": {"type": "pack", "short_path": paths["short_path"],
                           "long_path": paths["long_path"]},
            "patch_size": traffic["patch"],
            "samples_per_pair": traffic["samples_per_pair"],
            "random_crop": True,
            "batch_size_per_gpu": traffic["batch"]}},
        "logger": {"print_freq": 10 ** 9, "save_checkpoint_freq": 0,
                   "use_tb_logger": False},
        "path": {},
    }


def sync(device) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


class Step:
    """The Trainer's ``step_fn``, wrapped (see the module docstring)."""

    def __init__(self, trainer, cell, run: Run, seed, seconds, trace, device,
                 t0, tmpdir):
        traffic = cell.traffic
        self.trainer, self.real = trainer, trainer.step_fn
        self.cell, self.run, self.seed, self.device = cell, run, seed, device
        self.seconds, self.t0 = seconds, t0
        self.names = [n for n, _ in trainer.net.named_parameters()]
        self.setup_steps = CHECKED + 1 + traffic["warmup_steps"]
        self.traced_steps = traffic["traced_steps"] if trace else 0
        self.spans = tr_mod.Spans(on=False)
        self.hooks = Hooks(trainer.net, run, self.spans) if trace else None
        self.prof = tr_mod.Profiler(os.path.join(tmpdir, "trace.json"))
        self.k = 0
        self.phase = "setup"
        self.last_ret = 0.0
        self.t_open = 0.0
        self.batches: List[torch.Tensor] = []
        self.losses: List[torch.Tensor] = []
        self.output = None
        self.grads: Dict[str, torch.Tensor] = {}
        self.updates: Dict[str, torch.Tensor] = {}

    def __call__(self, state, batch):
        self.spans.exit("trainer.data")
        self.k += 1
        k, start = self.k, time.perf_counter()
        if k <= CHECKED:
            self.batches.append(batch["gt"].detach().float().cpu())
        if k == 2:
            b1 = state.optimizer.b1
            self.grads = {n: (m / (1.0 - b1)).cpu()
                          for n, m in zip(self.names, state.optimizer.mu)}
        if k == CHECKED + 1:
            p0 = net_params(self.cell, self.seed, self.device)
            self.updates = {
                n: (p.detach() - p0[n]).cpu()
                for n, p in self.trainer.net.named_parameters()}
            del p0
        if k == 1:
            hook = self.trainer.net.register_forward_hook(self._keep_output)
        self.spans.enter("train.step")
        state, logs = self.real(state, batch)
        self.spans.exit("train.step")
        if k == 1:
            hook.remove()
        end = time.perf_counter()
        if k <= CHECKED:
            self.losses.append(logs["l_total"])
        self._advance(k, start, end)
        self.spans.enter("trainer.data")
        return state, logs

    def _keep_output(self, module, args, out) -> None:
        self.output = out.detach().float().cpu()

    def _advance(self, k: int, start: float, end: float) -> None:
        run = self.run
        if self.phase == "setup":
            if k == self.setup_steps:
                sync(self.device)
                self.t_open = self.last_ret = time.perf_counter()
                run.setup_s = self.t_open - self.t0
                self.phase = "window"
            return
        unit = Unit(start, end, wait=start - self.last_ret)
        self.last_ret = end
        if self.phase == "window":
            run.units.append(unit)
            if end - self.t_open < self.seconds:
                return
            sync(self.device)
            run.window_s = time.perf_counter() - self.t_open
            if not self.traced_steps:
                self.trainer.total_iters = k
                return
            self.phase = "tail"
            self.prof.start()
            self.spans.on = self.hooks.tracing = True
            self.spans.enter(tr_mod.WINDOW)
            self.last_ret = time.perf_counter()
            return
        run.traced.append(unit)
        if len(run.traced) == self.traced_steps:
            sync(self.device)
            self.spans.exit(tr_mod.WINDOW)
            self.spans.on = self.hooks.tracing = False
            self.prof.stop()
            run.trace = tr_mod.read_trace(self.prof.path, SPANS)
            os.remove(self.prof.path)
            self.trainer.total_iters = k


def run_train(cell, seed: int, seconds: float, trace: bool, device, t0: float,
              tmpdir: str):
    from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer

    cfg, traffic = cell.config, cell.traffic
    run = Run("train", cfg["dtype"], cfg["network_g"], cell.reference)
    run.step_shape = (traffic["batch"],
                      cell.reference.in_channels(cfg["network_g"]),
                      traffic["patch"], traffic["patch"])
    pairs = make_pairs(traffic, seed, device)
    log(f"{len(pairs)} pairs made")
    paths = write_sid_root(os.path.join(tmpdir, "sid"), pairs)
    log("packs written")
    trainer = Trainer(trainer_opt(cfg, traffic, paths, seed), device=device)
    trainer.net.load_state_dict(net_params(cell, seed, device))
    perceptual = getattr(trainer.loss, "perceptual", None)
    if perceptual is not None:
        perceptual.vgg.load_state_dict(
            make_params(vgg_shapes(), seed, "vgg", device, he=True))
    step = Step(trainer, cell, run, seed, seconds, trace, device, t0, tmpdir)
    log("trainer built")
    trainer.step_fn = step
    trainer.train()
    if device != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if step.hooks:
        step.hooks.remove()
    prog = {"losses": [float(x) for x in step.losses],
            "output": step.output,
            "grads": step.grads, "updates": step.updates}
    batches = step.batches
    del trainer, step
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    def check() -> Dict[str, float]:
        finder = CropFinder(pairs)
        locs, missing = [], 0
        for gt in batches:
            u16 = (gt * 65535.0).round().to(torch.int32).permute(
                0, 2, 3, 1).numpy().astype(np.uint16)
            found = [finder.find(u16[i]) for i in range(u16.shape[0])]
            missing += sum(f is None for f in found)
            locs.append([f for f in found if f is not None])
        if missing:
            return {"crops_missing": float(missing)}
        ref = reference_train(cell, seed, pairs, locs, device)
        readings = compare(prog, ref)
        readings["crops_missing"] = 0.0
        return readings
    return run, len(run.units), 0, check


def ref_batch(pairs, locs, patch: int, device) -> Dict[str, torch.Tensor]:
    scale = np.float32(1.0 / 65535.0)
    crop = lambda a, t, l: a[t:t + patch, l:l + patch].astype(np.float32) \
        * scale
    short = np.stack([crop(pairs[i][0], t, l) for i, t, l in locs])
    long = np.stack([crop(pairs[i][1], t, l) for i, t, l in locs])
    ratio = np.asarray([pairs[i][2] for i, _, _ in locs], np.float32)
    to = lambda a: torch.from_numpy(a).to(device).permute(0, 3, 1, 2) \
        .contiguous()
    return {"short": to(short), "gt": to(long),
            "ratio": torch.from_numpy(ratio).to(device),
            "lq": to(np.clip(short * ratio[:, None, None, None], 0.0, 1.0))}


def reference_train(cell, seed, pairs, locs, device, quant=None,
                    fault: Optional[str] = None) -> dict:
    """The recipe's first steps in plain fp32 PyTorch, in chunks of
    ``ref_chunk`` images whose losses and gradients are averaged (every
    loss term is a mean over the batch). ``quant`` is the control's
    rounding; ``fault`` puts a stand-in for a broken step in its place:
    ``half_rows`` steps on the first half of each batch, ``half_loss``
    runs the forward on every row and the loss on the first half, and
    ``climb`` hands the optimizer the gradient's negative."""
    cfg, traffic, ref = cell.config, cell.traffic, cell.reference
    params = net_params(cell, seed, device)
    for t in params.values():
        t.requires_grad_(True)
    names = list(params)
    leaves = [params[n] for n in names]
    p0 = {n: t.detach().clone() for n, t in params.items()}
    weights = loss_weights(cfg["train"])
    vgg = make_params(vgg_shapes(), seed, "vgg", device, he=True) \
        if weights.get("perc") else None
    opt = AdamWClip(leaves, cfg["train"])
    chunk = traffic["ref_chunk"]
    out = {"losses": [], "raw_norms": {}, "grads": {}, "output": [],
           "lq": []}
    for k, loc in enumerate(locs[:CHECKED]):
        half = max(len(loc) // 2, 1)
        loc = loc[:half] if fault == "half_rows" else loc
        n_loss = half if fault == "half_loss" else len(loc)
        grads = [torch.zeros_like(t) for t in leaves]
        total = 0.0
        for c in range(0, len(loc), chunk):
            part = loc[c:c + chunk]
            b = ref_batch(pairs, part, traffic["patch"], device)
            y = ref.forward(b["lq"], params, cfg["network_g"], quant)
            if k == 0:
                out["output"].append(y.detach().cpu())
                out["lq"].append(b["lq"].cpu())
            rows = min(len(part), n_loss - c)
            if rows <= 0:
                continue
            loss, _ = newbp_loss(y[:rows], {key: v[:rows]
                                            for key, v in b.items()},
                                 vgg, weights, quant)
            w = rows / n_loss
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
                acc.add_(g, alpha=w)
            total += w * float(loss.detach())
        out["losses"].append(total)
        if k == 0:
            out["raw_norms"] = {n: float(g.norm())
                                for n, g in zip(names, grads)}
        if fault == "climb":
            grads = [-g for g in grads]
        clipped = opt.step(grads)
        if k == 0:
            out["grads"] = dict(zip(names, clipped))
    out["output"] = torch.cat(out["output"])
    out["lq"] = torch.cat(out["lq"])
    out["updates"] = {n: params[n].detach() - p0[n] for n in names}
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of a training cell.

    ``fwd_gap``: the first step's network output against the reference's,
    the L2 of their difference over the L2 of what the reference adds to
    its input, over the whole batch (a batch with rows left out reads
    infinity). ``loss_gap_step1``: the first step's loss, relative
    (``loss_gap`` is the worst of the three checked steps, whose later
    losses carry the drift of two bf16 updates). By the worst leaf, the
    first clipped gradient's norm (``grad_gap``) and the norm of the
    parameters' change after three steps (``update_gap``), each gap
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Over all leaves together, the L2 of the
    difference of the first clipped gradients (``grad_diff``) and of the
    changes after three steps (``update_diff``), each over the
    reference's L2: the norms above cannot see which rows trained or
    which way a step went, these can. ``*_diff_leaf``: the same by the
    worst leaf, as ``grad_gap`` weighs it; ``*_diff_median``: the median
    over the leaves of each leaf's L2 difference over its reference L2,
    steady from seed to seed where the worst leaf is not. Leaves whose
    reference gradient is under a thousandth of the median leaf's are
    left out (``excluded``)."""
    med_raw = statistics.median(ref["raw_norms"].values())
    kept = [n for n, v in ref["raw_norms"].items() if v >= 1e-3 * med_raw]
    readings = {"excluded": float(len(ref["raw_norms"]) - len(kept))}
    for key in ("grads", "updates"):
        r = {n: ref[key][n] for n in kept}
        got = {n: prog[key][n].to(r[n].device) if n in prog[key]
               else torch.zeros_like(r[n]) for n in kept}
        ref_n = {n: float(r[n].norm()) for n in kept}
        prog_n = {n: float(got[n].norm()) for n in kept}
        diff_n = {n: float((got[n] - r[n]).norm()) for n in kept}
        med = statistics.median(ref_n.values())
        floor = {n: max(ref_n[n], med) for n in kept}
        gap = {n: abs(prog_n[n] - ref_n[n]) / floor[n] for n in kept}
        leaf = {n: diff_n[n] / floor[n] for n in kept}
        name = key[:-1]
        readings[f"{name}_gap"] = max(gap.values())
        readings[f"{name}_diff"] = math.sqrt(
            sum(v * v for v in diff_n.values())
            / sum(v * v for v in ref_n.values()))
        readings[f"{name}_diff_leaf"] = max(leaf.values())
        readings[f"{name}_diff_median"] = statistics.median(
            diff_n[n] / ref_n[n] for n in kept)
        for what, by in (("gap", gap), ("diff_leaf", leaf)):
            n = max(by, key=by.get)
            log(f"{name}_{what} worst leaf {n} {tuple(r[n].shape)}: "
                f"{by[n]:.4g} (reference norm {ref_n[n]:.4g}, median "
                f"leaf {med:.4g}, program {prog_n[n]:.4g})")
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) < len(ref["losses"]):
        loss_gap = float("inf")
    got, ref_out = prog["output"], ref["output"]
    readings["fwd_gap"] = (
        float((got - ref_out).norm() / (ref_out - ref["lq"]).norm())
        if got is not None and got.shape == ref_out.shape
        else float("inf"))
    readings["loss_gap"] = loss_gap
    readings["loss_gap_step1"] = (abs(prog["losses"][0] - ref["losses"][0])
                                  / abs(ref["losses"][0]))
    return readings


def control_pairs_locs(cell, seed: int, device):
    """Seeded crops for runs that do not go through the program: each of
    the checked steps a batch of random crops of the cell's data."""
    traffic = cell.traffic
    pairs = make_pairs(traffic, seed, device)
    rng = np.random.default_rng(subseed(seed, "control_crops"))
    ps = traffic["patch"]
    locs = []
    for _ in range(CHECKED):
        loc = []
        for _ in range(traffic["batch"]):
            i = int(rng.integers(0, len(pairs)))
            h, w = pairs[i][1].shape[:2]
            loc.append((i, int(rng.integers(0, h - ps + 1)),
                        int(rng.integers(0, w - ps + 1))))
        locs.append(loc)
    return pairs, locs


STAND_INS = (("control_fp8", {"quant": fp8_round}),
             ("fault_half_rows", {"fault": "half_rows"}),
             ("fault_half_loss", {"fault": "half_loss"}),
             ("fault_climb", {"fault": "climb"}))


def control_readings(cell, seed: int, device) -> Dict[str, Dict[str, float]]:
    """Readings of the stand-ins for the program on one seed: the
    reference in fp8 (the control) and the reference with each fault of
    ``reference_train``, each judged against the fp32 reference as the
    program is (their crops are known, so none is missing)."""
    pairs, locs = control_pairs_locs(cell, seed, device)
    ref = reference_train(cell, seed, pairs, locs, device)
    out = {}
    for name, kw in STAND_INS:
        log(name)
        stand_in = reference_train(cell, seed, pairs, locs, device, **kw)
        out[name] = dict(compare(stand_in, ref), crops_missing=0.0)
        del stand_in
    return out
