"""Training logging (reference ``basicsr/utils/logger.py``).

Counterpart of ``lowlight_image_enhancement_tpu/training/logging_utils.py``,
with the same message format:

- :class:`MessageLogger` — console format with epoch/iter/lr/ETA/timings,
  ``l_*`` keys routed to ``losses/`` and ``m_*`` to ``metrics/`` TB scalar
  namespaces at the reference's normalized global step
  ``10000 * iter / total_iter`` (``logger.py:75-90``).
- :func:`init_tb_logger` — ``torch.utils.tensorboard``'s SummaryWriter, or
  None when the ``tensorboard`` package is missing.
- :func:`get_root_logger` — process-wide logger with optional file handler.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Any, Dict, Mapping, Optional

_LOGGER_NAME = "llie_torch"


def get_root_logger(log_file: Optional[str] = None,
                    level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S"
    )
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def init_wandb_logger(opt: Mapping[str, Any]) -> None:
    """wandb in tensorboard-sync mode (reference ``logger.py:101-125``):
    wandb only mirrors the TensorBoard event stream; ``resume_id`` in
    ``logger.wandb`` resumes an existing run. Import-guarded — a missing
    wandb package logs a warning instead of failing the run. Main-process
    only (the reference's ``@master_only``): other ranks of a
    ``torch.distributed`` world return at once."""
    from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
        host_info,
    )

    if not host_info()[2]:
        return
    logger = get_root_logger()
    try:
        import wandb
    except ImportError:
        logger.warning(
            "logger.wandb configured but the wandb package is not "
            "installed — skipping wandb sync.")
        return

    wandb_opt = (opt.get("logger", {}) or {}).get("wandb", {}) or {}
    project = wandb_opt["project"]
    resume_id = wandb_opt.get("resume_id")
    if resume_id:
        wandb_id = resume_id
        resume = "allow"
        logger.warning("Resume wandb logger with id=%s.", wandb_id)
    else:
        wandb_id = wandb.util.generate_id()
        resume = "never"
    wandb.init(
        id=wandb_id,
        resume=resume,
        name=opt.get("name"),
        config=dict(opt),
        project=project,
        sync_tensorboard=True,
    )
    logger.info("Use wandb logger with id=%s; project=%s.", wandb_id,
                project)


def init_tb_logger(log_dir: str):
    """A ``torch.utils.tensorboard`` SummaryWriter, or None when the
    ``tensorboard`` package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


class MessageLogger:
    """Console + TensorBoard training logger (reference ``logger.py:37-91``)."""

    def __init__(self, opt: Mapping[str, Any], start_iter: int = 1,
                 tb_logger=None):
        self.exp_name = opt.get("name", "experiment")
        logger_opt = opt.get("logger", {}) or {}
        self.interval = logger_opt.get("print_freq", 100)
        self.start_iter = start_iter
        train_opt = opt.get("train", {}) or {}
        self.max_iters = train_opt.get("total_iter", 1)
        self.use_tb = tb_logger is not None
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: Dict[str, Any]) -> None:
        current_iter = int(log_vars.pop("iter"))
        epoch = int(log_vars.pop("epoch", 0))
        lrs = log_vars.pop("lrs", [])

        msg = (f"[{self.exp_name}][epoch:{epoch:3d}, "
               f"iter:{current_iter:8,d}, "
               f"lr:(" + ", ".join(f"{lr:.3e}" for lr in lrs) + ")] ")

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1,
                                            1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta = str(datetime.timedelta(seconds=int(max(eta_sec, 0))))
            msg += (f"[eta: {eta}, time (data): {iter_time:.3f} "
                    f"({data_time:.3f})] ")

        for k, v in log_vars.items():
            v = float(v)
            msg += f"{k}: {v:.4e} "
            if self.use_tb:
                normed_step = 10000 * (current_iter / self.max_iters)
                normed_step = int(normed_step)
                if k.startswith("l_"):
                    self.tb_logger.add_scalar(f"losses/{k}", v, normed_step)
                elif k.startswith("m_"):
                    self.tb_logger.add_scalar(f"metrics/{k}", v, normed_step)
                else:
                    self.tb_logger.add_scalar(k, v, normed_step)
        self.logger.info(msg)
