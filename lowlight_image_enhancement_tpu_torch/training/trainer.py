"""Experiment trainer: config -> data -> model -> loop.

Counterpart of ``lowlight_image_enhancement_tpu/training/trainer.py``
(reference ``basicsr/train.py:100-335`` and
``ImageRestorationModel.init_training_settings``): the loss factories, and
:class:`Trainer`, which builds the data sets and loaders, the network,
loss, schedule and optimizer from a parsed config, auto-resumes, and runs
the iteration loop with periodic logging, checkpoints and validation, on
``device`` ("cuda" unless the caller asks for the CPU). Batches reach the
step through the loader's device prefetcher, NCHW. The train loader loads
ahead on a thread pool (``data.loader_threads``: the options'
``num_worker_per_gpu``, else the batch within a quarter of the CPUs)
where its data set draws its crops apart from its decode, so the batches
are the serial loader's; the pool serves the whole run and ends with
``train()``.

Under a ``torch.distributed`` world (``parallel.init_multihost``; one
process per device) the Trainer trains data-parallel over the world's
mesh: each rank loads ``batch_size_per_gpu`` items of its stride of the
data (per rank, as the reference's DDP; JAX's one-process mesh splits
that batch instead), starts from rank 0's parameters, seeds its drop-path
generator and mixup with ``manual_seed + rank`` (BasicSR's
``set_random_seed(seed + rank)``), all-reduces the gradients in the step,
shards the optimizer state with ``train.zero1`` (``parallel/zero.py``),
logs and writes checkpoints on rank 0 and validates with
``dist_validate``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.data import (
    create_dataset,
    create_loader,
    loader_threads,
)
from lowlight_image_enhancement_tpu_torch.data import epochs as epoch_stream
from lowlight_image_enhancement_tpu_torch.data import prefetch_to_device
from lowlight_image_enhancement_tpu_torch.losses import (
    assert_finite_logs,
    build_loss,
)
from lowlight_image_enhancement_tpu_torch.losses.hybrid import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel.mesh import (
    create_mesh,
    put_replicated,
)
from lowlight_image_enhancement_tpu_torch.parallel.multihost import host_info
from lowlight_image_enhancement_tpu_torch.parallel.zero import (
    zero1_device_put,
)
from lowlight_image_enhancement_tpu_torch.ops.psf import (
    build_psf_kernels,
    create_crosstalk_psf,
    normalize_psf_energy,
)
from lowlight_image_enhancement_tpu_torch.training import checkpoint as ckpt
from lowlight_image_enhancement_tpu_torch.training.config import dict2str
from lowlight_image_enhancement_tpu_torch.training.logging_utils import (
    MessageLogger,
    get_root_logger,
    init_tb_logger,
    init_wandb_logger,
)
from lowlight_image_enhancement_tpu_torch.training.schedules import (
    make_schedule,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    TrainState,
    attach_generator,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from lowlight_image_enhancement_tpu_torch.training.validation import (
    dist_validate,
)
from lowlight_image_enhancement_tpu_torch.utils.profiling import span


def build_hybrid_loss(train_opt: Mapping[str, Any],
                      device: Any = "cuda") -> Optional[HybridLossPlus]:
    """``HybridLossPlus`` from the ``train.hybrid_opt`` block (reference
    ``image_restoration_model.py:76-101``), on ``device``:

    - ``pretrained`` becomes ``require_pretrained`` (default True: a
      config that asks for the perceptual term gets ImageNet VGG19 or an
      error; ``pretrained: false`` opts into the random trunk);
    - ``enable_amp`` runs the perceptual trunk in bf16;
    - ``perceptual.pool_impl`` selects the trunk's max-pool implementation
      (``models/vgg.py``; absent: the default);
    - the ``physics`` block becomes a ``CrosstalkPSF`` (sRGB, default) or,
      with ``domain: raw``, the normalised raw kernel."""
    hybrid_opt = train_opt.get("hybrid_opt")
    if not hybrid_opt:
        return None
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = dict(hybrid_opt)
    kwargs.pop("type", None)
    kwargs.pop("device", None)
    physics = kwargs.pop("physics", None)
    perceptual = kwargs.pop("perceptual", None) or {}
    if "pool_impl" in perceptual:
        kwargs["perc_pool_impl"] = perceptual["pool_impl"]
    kwargs.setdefault("require_pretrained",
                      bool(kwargs.pop("pretrained", True)))
    if train_opt.get("enable_amp", False):
        kwargs.setdefault("perc_dtype", torch.bfloat16)
    if physics and kwargs.get("use_phys", True):
        mode = physics.get("mode", "mono")
        spec = physics.get("kernel_spec")
        if physics.get("domain", "srgb") == "raw":
            kwargs["physics_kernel"] = normalize_psf_energy(build_psf_kernels(
                mode, spec or ("P2" if mode == "mono" else "B2"))).to(dev)
        else:
            kwargs["physics_psf_module"] = create_crosstalk_psf(mode, spec)
    return HybridLossPlus(**kwargs).to(dev)


def build_training_losses(train_opt: Mapping[str, Any], device: Any = "cuda"
                          ) -> Tuple[HybridLossPlus, Optional[Callable]]:
    """``(loss, pixel_loss)`` for ``make_train_step`` as the JAX ``Trainer``
    sets them up: the ``hybrid_opt`` loss, and the ``pixel_opt`` loss when
    the config has one. A pixel-only config (``configs/stereo_nafssr.yml``)
    gets a ``HybridLossPlus`` with every term off and the raw L1 weighted
    0, so the pixel loss is the whole objective."""
    loss = build_hybrid_loss(train_opt, device)
    if loss is None:
        loss = HybridLossPlus(
            w_l1_raw=0.0 if train_opt.get("pixel_opt") else 1.0,
            use_perc=False, use_deltaE=False, use_ssim=False,
            use_phys=False).to(resolve_device(device))
    pixel_loss = (build_loss(train_opt["pixel_opt"])
                  if train_opt.get("pixel_opt") else None)
    return loss, pixel_loss


def optimizer_from_config(train_opt: Mapping[str, Any]):
    """``(optimizer, schedule)`` from a ``train`` block: ``optim_g`` (AdamW
    at lr 1e-3 by default), ``scheduler`` (a constant lr without one),
    ``use_grad_clip`` and ``accum_steps``."""
    optim_opt = dict(train_opt.get("optim_g", {"type": "AdamW", "lr": 1e-3}))
    base_lr = float(optim_opt.pop("lr", 1e-3))
    sched_opt = train_opt.get("scheduler")
    schedule = (make_schedule(sched_opt, base_lr,
                              warmup_iter=train_opt.get("warmup_iter", -1))
                if sched_opt else (lambda step: base_lr))
    optimizer = make_optimizer(
        schedule,
        optim_type=optim_opt.pop("type", "AdamW"),
        betas=tuple(optim_opt.pop("betas", (0.9, 0.999))),
        weight_decay=float(optim_opt.pop("weight_decay", 0.01)),
        use_grad_clip=bool(train_opt.get("use_grad_clip", True)),
        accum_steps=int(train_opt.get("accum_steps", 1)))
    return optimizer, schedule


class Trainer:
    """End-to-end experiment runner over a parsed config dict.

    ``history`` keeps one dict per printed iteration (``iter``, ``lr``,
    ``time``, ``data_time`` and the step's logs as floats). Under a
    profiler each iteration records a ``trainer.fetch`` span (the loader
    and prefetcher's ``next``) and a ``trainer.step`` span (the step),
    both with the iteration as their unit (``utils/profiling.py``). The step's
    logs stay device tensors between prints: an iteration that does not
    print does not wait for the device. ``last_val`` holds the latest
    validation's results.

    ``mesh``: a process-group mesh (``parallel.create_mesh``); by default
    the world's when ``torch.distributed`` is initialised. Its device
    replaces ``device``."""

    def __init__(self, opt: Mapping[str, Any], device: Any = "cuda",
                 mesh=None):
        self.opt = dict(opt)
        if mesh is None and torch.distributed.is_initialized():
            mesh = create_mesh()
        if mesh is not None and not mesh.distributed:
            raise ValueError("the Trainer runs one process per device: "
                             "pass the mesh of a torch.distributed world")
        self.mesh = mesh
        self.rank, self.world, self.is_main = host_info()
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.logger = get_root_logger(
            os.path.join(opt["path"]["log"], "train.log")
            if (opt.get("path") or {}).get("log") and self.is_main
            else None, level=logging.INFO if self.is_main else logging.WARNING)
        seed = int(opt.get("manual_seed", 0))
        np.random.seed(seed)
        torch.manual_seed(seed)

        # --- data -----------------------------------------------------
        # train: this rank's stride, batch_size_per_gpu items per rank;
        # val: every image, strided by dist_validate
        ds_opts = opt.get("datasets") or {}
        self.train_loader = self.val_loader = None
        if "train" in ds_opts:
            train_set = create_dataset(ds_opts["train"])
            self.train_loader = create_loader(
                train_set, ds_opts["train"], seed=seed,
                num_hosts=self.world, host_id=self.rank,
                num_workers=loader_threads(train_set, ds_opts["train"]))
        if "val" in ds_opts:
            self.val_loader = create_loader(
                create_dataset(ds_opts["val"]), ds_opts["val"], seed=seed)

        # --- model / loss / optimizer ---------------------------------
        train_opt = opt.get("train") or {}
        net_opt = dict(opt["network_g"])
        if train_opt.get("enable_amp"):
            net_opt.setdefault("dtype", "bfloat16")
        self.net = define_network(net_opt, device=self.device)
        attach_generator(self.net, self.device, seed + self.rank)
        self.loss, self.pixel_loss = build_training_losses(train_opt,
                                                           self.device)
        self.optimizer, self.schedule = optimizer_from_config(train_opt)
        self.state = create_train_state(self.net, self.optimizer, self.loss)
        self._zero1_shardings = None
        if mesh is not None:
            put_replicated(self.state, mesh)
            if train_opt.get("zero1"):
                _, self._zero1_shardings = zero1_device_put(self.state, mesh)
        elif train_opt.get("zero1"):
            self.logger.warning("train.zero1 needs a torch.distributed "
                                "world; one process trains unsharded")
        self.total_iters = int(train_opt.get("total_iter", 1000))
        mixup = train_opt.get("mixup", False)
        self.step_fn = make_train_step(
            self.net, self.loss, self.optimizer, pixel_loss=self.pixel_loss,
            mixup_alpha=(1.2 if mixup is True else mixup) or None,
            seed=seed + self.rank, mesh=mesh)
        self.eval_fn = make_eval_step(self.net)
        self.history: List[Dict[str, float]] = []
        self.last_val: Dict[str, float] = {}

        # --- resume ---------------------------------------------------
        self.start_iter = 0
        states_dir = (opt.get("path") or {}).get("training_states")
        if states_dir and ckpt.auto_resume(states_dir, self.state):
            self.start_iter = int(self.state.step)
            self.logger.info("auto-resumed at iter %d", self.start_iter)

    # ------------------------------------------------------------------
    def train(self) -> TrainState:
        opt = self.opt
        if self.train_loader is None:
            raise ValueError("config has no datasets.train")
        logger_opt = opt.get("logger") or {}
        print_freq = int(logger_opt.get("print_freq", 100))
        save_freq = int(logger_opt.get("save_checkpoint_freq", 5000))
        val_opt = opt.get("val") or {}
        val_freq = int(val_opt.get("val_freq", 0) or 0)

        # wandb before the TB writer, so that sync_tensorboard hooks the
        # event stream (reference train.py:109-115)
        main = self.is_main
        if main and (logger_opt.get("wandb") or {}).get("project") is not None:
            init_wandb_logger(opt)
        tb = (init_tb_logger(opt["path"]["log"])
              if main and logger_opt.get("use_tb_logger") else None)
        msg_logger = (MessageLogger(opt, self.start_iter + 1, tb) if main
                      else (lambda log_vars: None))
        self.logger.info("config:\n%s", dict2str(self.opt))

        # resume the shuffle sequence at the epoch the run left off in
        start_epoch = self.start_iter // max(len(self.train_loader), 1)
        batches = epoch_stream(self.train_loader, start_epoch=start_epoch)
        stream = prefetch_to_device(batches, device=self.device)
        try:
            current_iter = self.start_iter
            t_data = time.time()
            while current_iter < self.total_iters:
                with span("trainer.fetch", unit=current_iter + 1):
                    batch = next(stream, None)
                if batch is None:
                    break
                current_iter += 1
                data_time = time.time() - t_data
                t_step = time.time()
                with span("trainer.step", unit=current_iter):
                    self.state, logs = self.step_fn(self.state, batch)

                if current_iter % print_freq == 0:
                    host_logs = {k: float(v) for k, v in logs.items()}
                    assert_finite_logs(host_logs)
                    entry = {"iter": current_iter,
                             "lr": float(self.schedule(current_iter)),
                             "time": time.time() - t_step,
                             "data_time": data_time, **host_logs}
                    self.history.append(entry)
                    msg_logger({"iter": current_iter,
                                "epoch": self.train_loader.epoch,
                                "lrs": [entry["lr"]], "time": entry["time"],
                                "data_time": data_time, **host_logs})
                if save_freq and current_iter % save_freq == 0:
                    self._save()
                if val_freq and self.val_loader is not None and (
                        current_iter % val_freq == 0):
                    results = self.validate()
                    msg_logger({"iter": current_iter,
                                "epoch": self.train_loader.epoch,
                                "lrs": [float(self.schedule(current_iter))],
                                **{f"m_{k}": v for k, v in results.items()}})
                t_data = time.time()
        finally:
            stream.close()
            batches.close()   # the loader's pool ends with train()

        self._save()
        if self.val_loader is not None and val_freq:
            self.logger.info("final validation: %s", self.validate())
        if tb is not None:
            tb.close()
        return self.state

    # ------------------------------------------------------------------
    def _save(self) -> None:
        """Checkpoints on rank 0 (under ZeRO-1 every rank first gives its
        moment slices), the other ranks waiting behind a barrier."""
        paths = self.opt.get("path") or {}
        if paths.get("training_states"):
            ckpt.save_training_state(paths["training_states"], self.state)
        if paths.get("models") and self.is_main:
            ckpt.save_network(paths["models"], self.state)
        if self.mesh is not None:
            torch.distributed.barrier(group=self.mesh.group)

    def validate(self) -> Dict[str, float]:
        """The config's ``val.metrics`` over the val loader, the network in
        eval mode on the device (tiled when ``val.crop_size`` is set); under
        a world each rank takes its stride of the images and every rank
        gets the global means."""
        if self.val_loader is None:
            return {}
        val_opt = self.opt.get("val") or {}
        self.last_val = dist_validate(
            self.eval_fn, self.val_loader, val_opt.get("metrics") or {},
            device=self.device, tile_size=val_opt.get("crop_size"),
            max_images=val_opt.get("max_images"),
            save_dir=((self.opt.get("path") or {}).get("visualization")
                      if val_opt.get("save_img") else None))
        return self.last_val


def train_from_config(opt: Mapping[str, Any], mesh=None,
                      device: Any = "cuda") -> TrainState:
    return Trainer(opt, device=device, mesh=mesh).train()
