"""Reference-API model wrappers (the ``MODEL_REGISTRY`` layer).

Counterpart of ``lowlight_image_enhancement_tpu/training/model_wrapper.py``
(reference ``basicsr/models/image_restoration_model.py``,
``lowlight_model.py``, ``models/__init__.py:37-78``): the imperative API
that downstream code scripts against, over the port's functional core
(``make_train_step`` / ``make_eval_step``, ``checkpoint.py``,
``validation.py``), on ``device`` ("cuda" unless the caller asks for the
CPU):

- :func:`create_model` -- ``MODEL_REGISTRY`` lookup of ``model_type``;
- :class:`ImageRestorationModel` -- ``feed_data``, ``optimize_parameters``,
  ``test``, ``grids`` / ``grids_inverse`` / ``test_grids``,
  ``get_current_visuals``, ``validation``, ``save``, ``resume_training``,
  ``load_network``, ``get_current_log``, ``get_current_learning_rate``;
- :class:`LowlightModel` -- the simpler wrapper: the sum of the configured
  pixel / perceptual / SSIM losses (L1 when none is), a constant learning
  rate, no clip by default.

Batches come in NHWC numpy, as the JAX wrappers and the :class:`Loader`
have them; ``feed_data`` moves the numeric arrays to the device, NCHW.
``output`` is an NCHW tensor on the device; ``get_current_visuals``
returns NHWC numpy arrays. A network with drop-path or dropout draws its
masks from a device ``torch.Generator`` seeded by ``manual_seed``.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.losses import build_loss
from lowlight_image_enhancement_tpu_torch.losses.hybrid import HybridLossPlus
from lowlight_image_enhancement_tpu_torch.models import define_network
from lowlight_image_enhancement_tpu_torch.parallel.multihost import host_info
from lowlight_image_enhancement_tpu_torch.training import checkpoint as ckpt
from lowlight_image_enhancement_tpu_torch.training.schedules import (
    make_schedule,
)
from lowlight_image_enhancement_tpu_torch.training.train_step import (
    attach_generator,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from lowlight_image_enhancement_tpu_torch.training.trainer import (
    build_hybrid_loss,
)
from lowlight_image_enhancement_tpu_torch.training.validation import (
    allreduce_metric_sums,
    compute_metrics,
    save_result_image,
    tiled_inference,
)
from lowlight_image_enhancement_tpu_torch.utils.registry import MODEL_REGISTRY

logger = logging.getLogger(__name__)

_BATCH_KEYS = ("lq", "gt", "short_raw", "long_raw", "short_obs",
               "expo_ratio")


def create_model(opt: Mapping[str, Any], device: Any = "cuda"):
    """A model wrapper from ``opt['model_type']`` (reference
    ``models/__init__.py:37-78``)."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)


def _loss_on(opt: Mapping[str, Any], device: torch.device):
    """``build_loss(opt)``, moved to ``device`` where it is a module (the
    elementwise losses are plain callables)."""
    loss = build_loss(opt)
    return loss.to(device) if isinstance(loss, torch.nn.Module) else loss


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).cpu().numpy()


class _BaseWrapper:
    """Shared plumbing (reference ``BaseModel``): checkpoints, logs, the
    learning rate, and moving NHWC batches to the device."""

    def __init__(self, opt: Mapping[str, Any], device: Any = "cuda"):
        self.opt = dict(opt)
        self.device = resolve_device(device)
        self.is_train = opt.get("is_train", True)
        self.log_dict: Dict[str, float] = OrderedDict()
        self.batch: Dict[str, torch.Tensor] = {}
        self.output: Optional[torch.Tensor] = None
        self.seed = int(opt.get("manual_seed", 0))
        torch.manual_seed(self.seed)

    def _build_net(self, net_opt: Mapping[str, Any]):
        net = define_network(dict(net_opt), device=self.device)
        attach_generator(net, self.device, self.seed)
        return net

    def _to_device(self, value) -> torch.Tensor:
        """A NHWC image batch -> NCHW on the device; other arrays as they
        are."""
        t = torch.as_tensor(np.asarray(value, np.float32)).to(self.device)
        return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t

    def _record(self, logs: Mapping[str, torch.Tensor]) -> None:
        self.log_dict = OrderedDict((k, float(v)) for k, v in logs.items())

    # -- checkpoints (reference save / resume surface) -------------------
    def save(self, epoch: int = -1, current_iter: int = -1) -> None:
        paths = self.opt.get("path") or {}
        if paths.get("training_states"):
            ckpt.save_training_state(paths["training_states"], self.state)
        if paths.get("models"):
            ckpt.save_network(paths["models"], self.state)

    def resume_training(self, resume_state_path: Optional[str] = None) -> int:
        """Restore ``resume_state_path`` (else the latest state under
        ``path.training_states``); returns the step, 0 when none was
        found."""
        if resume_state_path:
            ckpt.restore_training_state(resume_state_path, self.state)
        elif ckpt.auto_resume((self.opt.get("path") or {}).get(
                "training_states", ""), self.state) is None:
            return 0
        return int(self.state.step)

    def load_network(self, path: str, strict: bool = True) -> None:
        ckpt.restore_network(path, self.net_g, strict=strict)

    def get_current_log(self) -> Dict[str, float]:
        return dict(self.log_dict)

    def get_current_learning_rate(self, current_iter: Optional[int] = None):
        step = current_iter if current_iter is not None else self.state.step
        return [float(self.schedule(int(step)))]

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """``lq``, ``result`` and ``gt`` as NHWC float32 numpy arrays."""
        out = {"lq": _to_nhwc(self.batch["lq"])}
        if self.output is not None:
            out["result"] = _to_nhwc(self.output)
        if "gt" in self.batch:
            out["gt"] = _to_nhwc(self.batch["gt"])
        return out


@MODEL_REGISTRY.register()
class ImageRestorationModel(_BaseWrapper):
    """The primary training wrapper (reference
    ``image_restoration_model.py:30-552``): the ``hybrid_opt`` loss (else
    ``HybridLossPlus`` with the raw L1 alone) plus the ``pixel_opt`` loss,
    the configured schedule, AdamW with the global-norm clip."""

    def __init__(self, opt: Mapping[str, Any], device: Any = "cuda"):
        super().__init__(opt, device)
        train_opt = opt.get("train") or {}
        net_opt = dict(opt["network_g"])
        if train_opt.get("enable_amp"):
            net_opt.setdefault("dtype", "bfloat16")
        self.net_g = self._build_net(net_opt)

        self.cri_hybrid = build_hybrid_loss(train_opt, self.device)
        self.cri_pix = (_loss_on(train_opt["pixel_opt"], self.device)
                        if train_opt.get("pixel_opt") else None)
        loss = self.cri_hybrid or HybridLossPlus(
            use_perc=False, use_deltaE=False, use_ssim=False,
            use_phys=False).to(self.device)

        optim_opt = dict(train_opt.get("optim_g",
                                       {"type": "AdamW", "lr": 1e-3}))
        base_lr = float(optim_opt.pop("lr", 1e-3))
        sched_opt = train_opt.get("scheduler")
        self.schedule = (
            make_schedule(sched_opt, base_lr,
                          warmup_iter=train_opt.get("warmup_iter", -1))
            if sched_opt else (lambda step: base_lr))
        self.optimizer = make_optimizer(
            self.schedule,
            optim_type=optim_opt.pop("type", "AdamW"),
            betas=tuple(optim_opt.pop("betas", (0.9, 0.999))),
            weight_decay=float(optim_opt.pop("weight_decay", 0.01)),
            use_grad_clip=bool(train_opt.get("use_grad_clip", True)),
            accum_steps=int(train_opt.get("accum_steps", 1)))
        self.state = create_train_state(self.net_g, self.optimizer, loss)
        self._train_step = make_train_step(self.net_g, loss, self.optimizer,
                                           pixel_loss=self.cri_pix)
        self._eval_step = make_eval_step(self.net_g)
        self._grids_meta: Optional[dict] = None

    def feed_data(self, data: Mapping[str, Any], is_val: bool = False) -> None:
        self.batch = {k: self._to_device(data[k]) for k in _BATCH_KEYS
                      if data.get(k) is not None}

    def optimize_parameters(self, current_iter: int = 0,
                            tb_logger=None) -> None:
        self.state, logs = self._train_step(self.state, self.batch)
        self._record(logs)

    def test(self, max_minibatch: Optional[int] = None) -> None:
        if self._grids_meta:   # reference: grids() then test() runs tiled
            return self.test_grids()
        lq = self.batch["lq"]
        m = max_minibatch or lq.shape[0]
        self.output = torch.cat([self._eval_step(lq[i:i + m])
                                 for i in range(0, lq.shape[0], m)])

    def grids(self, crop_size: int = 256, overlap_ratio: float = 0.5) -> None:
        self._grids_meta = {"crop_size": crop_size,
                            "overlap_ratio": overlap_ratio}

    def grids_inverse(self) -> None:
        self._grids_meta = None

    def test_grids(self) -> None:
        """Tiled inference (``validation.tiled_inference``) of an N == 1
        batch with the ``grids`` crop size and overlap."""
        if not self._grids_meta:
            return self.test()

        def forward(tiles: np.ndarray) -> np.ndarray:
            return _to_nhwc(self._eval_step(self._to_device(tiles)))

        out = tiled_inference(forward, _to_nhwc(self.batch["lq"]),
                              self._grids_meta["crop_size"],
                              self._grids_meta["overlap_ratio"])
        self.output = self._to_device(out)

    def validation(self, dataloader, current_iter: int = 0, tb_logger=None,
                   save_img: bool = False, **kwargs) -> Dict[str, float]:
        """The mean of the config's ``val.metrics`` over the loader's
        batches; under a ``torch.distributed`` world each process takes
        the batches ``bidx % world == rank`` and the sums are all-reduced
        (reference ``dist_validation``, ``image_restoration_model.py:
        344-468``). ``save_img`` writes each result under
        ``path.visualization/<name>/<name>[_<iter>].png``."""
        metrics_opt = (self.opt.get("val") or {}).get("metrics") or {}
        vis_dir = (self.opt.get("path") or {}).get("visualization")
        rank, world, _ = host_info()
        sums: Dict[str, float] = {}
        n = 0
        for bidx, batch in enumerate(dataloader):
            if bidx % world != rank:
                continue
            self.feed_data(batch, is_val=True)
            self.test()
            if save_img:
                names = batch.get("pair_id")
                name = (str(names[0]) if names is not None
                        else f"img_{bidx:05d}")
                suffix = f"_{current_iter}" if self.opt.get("is_train") \
                    else ""
                save_result_image(os.path.join(
                    vis_dir or "visualization", name, f"{name}{suffix}.png"),
                    self.output[:1])
            for k, v in compute_metrics(self.output, self.batch["gt"],
                                        metrics_opt).items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        sums, n = allreduce_metric_sums(sums, n)
        results = {k: v / n for k, v in sums.items()} if n else {}
        self.log_dict.update({f"m_{k}": v for k, v in results.items()})
        return results


@MODEL_REGISTRY.register()
class LowlightModel(_BaseWrapper):
    """Simpler wrapper (reference ``lowlight_model.py:25-166``): the sum of
    the configured ``pixel_opt`` / ``perceptual_opt`` / ``ssim_opt`` losses
    (L1 when none is configured), a constant learning rate, AdamW (Adam,
    SGD) without clip unless ``use_grad_clip``. ``feed_data`` takes
    ``lq``/``gt`` or ``short``/``long``."""

    def __init__(self, opt: Mapping[str, Any], device: Any = "cuda"):
        super().__init__(opt, device)
        train_opt = opt.get("train") or {}
        self.net_g = self._build_net(opt["network_g"])

        def loss_of(key):
            return (_loss_on(train_opt[key], self.device)
                    if train_opt.get(key) else None)

        self.cri_pix = loss_of("pixel_opt")
        self.cri_perceptual = loss_of("perceptual_opt")
        self.cri_ssim = loss_of("ssim_opt")
        if not any([self.cri_pix, self.cri_perceptual, self.cri_ssim]):
            logger.warning(
                "LowlightModel: no losses configured; falling back to L1.")
            self.cri_pix = _loss_on({"type": "L1Loss"}, self.device)
        terms = [(name, cri) for name, cri in (
            ("l_pix", self.cri_pix), ("l_percep", self.cri_perceptual),
            ("l_ssim", self.cri_ssim)) if cri is not None]

        def summed(out: torch.Tensor, gt: torch.Tensor):
            logs = {name: cri(out, gt) for name, cri in terms}
            return sum(logs.values()), logs

        optim_opt = dict(train_opt.get("optim_g",
                                       {"type": "AdamW", "lr": 1e-3}))
        base_lr = float(optim_opt.pop("lr", 1e-3))
        self.schedule = lambda step: base_lr
        self.optimizer = make_optimizer(
            base_lr,
            optim_type=optim_opt.pop("type", "AdamW"),
            betas=tuple(optim_opt.pop("betas", (0.9, 0.999))),
            weight_decay=float(optim_opt.pop("weight_decay", 0.0)),
            use_grad_clip=bool(train_opt.get("use_grad_clip", False)),
            grad_clip_norm=float(train_opt.get("grad_clip_norm", 1.0)),
            accum_steps=int(train_opt.get("accum_steps", 1)))
        self.state = create_train_state(self.net_g, self.optimizer)
        self._train_step = make_train_step(self.net_g, None, self.optimizer,
                                           pixel_loss=summed)
        self._eval_step = make_eval_step(self.net_g)

    def feed_data(self, data: Mapping[str, Any], is_val: bool = False) -> None:
        lq = data.get("lq", data.get("short"))
        gt = data.get("gt", data.get("long"))
        self.batch = {"lq": self._to_device(lq)}
        if gt is not None:
            self.batch["gt"] = self._to_device(gt)

    def optimize_parameters(self, current_iter: int = 0,
                            tb_logger=None) -> None:
        self.state, logs = self._train_step(self.state, self.batch)
        logs.pop("grad_norm")   # the reference logs the loss terms alone
        self._record(logs)

    def test(self) -> None:
        self.output = self._eval_step(self.batch["lq"])
