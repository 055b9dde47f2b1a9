"""Functional training core: TrainState, the optimizer chain, train and
eval steps (NCHW).

Counterpart of ``lowlight_image_enhancement_tpu/training/train_step.py``
(reference ``ImageRestorationModel.optimize_parameters``,
``image_restoration_model.py:247-322``):

- batch wiring: ``Bhat_raw = net(lq)``, ``B_raw = long_raw (or gt)``,
  ``A_raw = short_raw (or lq)``, sRGB views are [0,1]-clamped copies,
  ``A_srgb01 = short_obs`` when present;
- :func:`make_optimizer` reproduces ``optax.chain(clip_by_global_norm(
  0.01), adamw(schedule))`` (and ``optax.MultiSteps`` for
  ``accum_steps > 1``) exactly, not ``torch.optim``: the clip scales by
  ``max_norm / |g|`` only when ``|g| >= max_norm`` (no epsilon), over the
  network and ``log_sigma`` grads together; AdamW adds ``ADAM_EPS``
  outside the square root and decays every parameter; the schedule is
  read at the number of updates already applied;
- mixed precision is the network's activation dtype (bf16), no scaler.

The port updates parameters and optimizer moments in place (PyTorch's
habit; the JAX step returns new arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from lowlight_image_enhancement_tpu_torch.training.augment import mixup_batch

Batch = Mapping[str, torch.Tensor]
# Adam's denominator epsilon, added outside the square root (optax's default)
ADAM_EPS = 1e-8


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class ChainOptimizer:
    """``[MultiSteps(] [clip_by_global_norm(max_norm) ->] AdamW | Adam | SGD
    [)]`` over a list of tensors, with optax's arithmetic.

    :meth:`init` binds the parameters and zeroes the state; :meth:`step`
    takes one gradient per parameter and updates the parameters in
    place (every ``accum_steps``-th call, with the running mean of the
    last ``accum_steps`` gradients)."""

    def __init__(self, learning_rate, optim_type: str = "AdamW",
                 betas=(0.9, 0.999), weight_decay: float = 0.01,
                 use_grad_clip: bool = True, grad_clip_norm: float = 0.01,
                 accum_steps: int = 1):
        if optim_type not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"unsupported optimizer {optim_type!r}")
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _step, lr=float(learning_rate): lr))
        self.optim_type = optim_type
        self.b1, self.b2 = (float(b) for b in betas)
        self.weight_decay = float(weight_decay) if optim_type == "AdamW" \
            else 0.0
        self.max_norm = float(grad_clip_norm) if use_grad_clip else None
        self.accum_steps = int(accum_steps)
        self.params: List[torch.Tensor] = []

    def init(self, params) -> "ChainOptimizer":
        self.params = list(params)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.count = 0        # updates applied (the schedule's step)
        self.mini_step = 0
        self.mu = zeros() if self.optim_type != "SGD" else None
        self.nu = zeros() if self.optim_type != "SGD" else None
        self.acc = zeros() if self.accum_steps > 1 else None
        return self

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        self._apply(grads)

    def _apply(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm is not None:
            g_norm = global_norm(grads)
            scale = torch.where(g_norm < self.max_norm,
                                torch.ones_like(g_norm),
                                self.max_norm / g_norm)
            for g in grads:
                g.mul_(scale)
        lr = float(self.schedule(self.count))
        self.count += 1
        if self.optim_type == "SGD":
            for p, g in zip(self.params, grads):
                p.add_(g, alpha=-lr)
            return
        # bias corrections in fp32, as optax computes 1 - decay**count
        one = np.float32(1.0)
        c1 = float(one - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(one - np.float32(self.b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u, alpha=-lr)


def make_optimizer(learning_rate, optim_type: str = "AdamW",
                   betas=(0.9, 0.999), weight_decay: float = 0.01,
                   use_grad_clip: bool = True, grad_clip_norm: float = 0.01,
                   accum_steps: int = 1) -> ChainOptimizer:
    """The reference recipe: AdamW (wd 0.01) on ``learning_rate`` (a float
    or a schedule ``step -> lr``), global-norm clip 0.01, optionally
    averaged over ``accum_steps`` micro-batches per applied step."""
    return ChainOptimizer(learning_rate, optim_type, betas, weight_decay,
                          use_grad_clip, grad_clip_norm, accum_steps)


@dataclass
class TrainState:
    """Step counter, the network, the bound optimizer (its parameters are
    the network's followed by ``log_sigma``'s) and the Kendall-Gal
    ``log_sigma`` (an empty ``ParameterDict`` when unused)."""

    step: int
    model: nn.Module
    optimizer: ChainOptimizer
    log_sigma: nn.ParameterDict


def create_train_state(net: nn.Module, optimizer: ChainOptimizer,
                       loss=None) -> TrainState:
    log_sigma = (loss.log_sigma if loss is not None and loss.use_uncertainty
                 else nn.ParameterDict())
    params = list(net.parameters()) + list(log_sigma.values())
    return TrainState(step=0, model=net, optimizer=optimizer.init(params),
                      log_sigma=log_sigma)


def attach_generator(net: nn.Module, device, seed: int) -> None:
    """Give a network that draws random masks in training mode (NAFSSR's
    drop-path, NAFNet's dropout: the modules with a ``generator``
    attribute) a ``torch.Generator`` on ``device`` seeded by ``seed``."""
    if hasattr(net, "generator"):
        net.generator = torch.Generator(device=device).manual_seed(int(seed))


def hybrid_batch_kwargs(output: torch.Tensor, batch: Batch) -> Dict:
    """A batch dict -> ``HybridLossPlus`` keywords (reference wiring,
    ``image_restoration_model.py:289-303``)."""
    gt = batch["gt"]
    short_obs = batch.get("short_obs")
    n = output.shape[0]
    expo = batch.get("expo_ratio")
    if expo is None:
        expo = torch.ones((n,), dtype=output.dtype, device=output.device)
    expo = torch.as_tensor(expo, device=output.device).reshape(n)
    return dict(
        Bhat_raw=output,
        B_raw=batch.get("long_raw", gt),
        A_raw=batch.get("short_raw", batch["lq"]),
        expo_ratio=expo,
        Bhat_srgb01=output.clamp(0.0, 1.0),
        B_srgb01=gt.clamp(0.0, 1.0),
        A_srgb01=(short_obs.clamp(0.0, 1.0)
                  if short_obs is not None else None),
    )


def make_train_step(net: nn.Module, loss, optimizer: ChainOptimizer,
                    pixel_loss: Optional[Callable] = None,
                    mixup_alpha: Optional[float] = None, seed: int = 0):
    """``train_step(state, batch) -> (state, logs)``: forward, loss,
    gradients of every trainable tensor, ``logs['grad_norm']`` (before the
    clip), one optimizer step. ``batch`` holds NCHW ``lq`` and ``gt`` and
    optionally ``short_raw``, ``long_raw``, ``short_obs``, ``expo_ratio``.
    The objective is ``pixel_loss(output, gt)`` plus ``loss`` (the
    ``HybridLossPlus`` term; None leaves it out). ``pixel_loss`` returns a
    tensor, logged as ``l_pix``, or a ``(total, logs)`` pair whose logs
    are taken as they are.
    Logs are detached tensors (no host sync). ``mixup_alpha`` mixes each
    batch first (:func:`..training.augment.mixup_batch`), with draws from a
    host generator seeded by ``seed``.

    Every call puts ``net`` in train mode and leaves it there (a module
    with drop-path then draws from its generator): call ``net.eval()``, or
    go through ``make_eval_step``, before using the bare ``net`` for
    inference between steps."""
    mixup_gen = (torch.Generator().manual_seed(int(seed)) if mixup_alpha
                 else None)

    def train_step(state: TrainState, batch: Batch):
        if mixup_alpha:
            batch = mixup_batch(batch, alpha=mixup_alpha, generator=mixup_gen)
        params = state.optimizer.params
        net.train()       # the JAX step applies with deterministic=False
        output = net(batch["lq"])
        total = torch.zeros((), device=output.device)
        logs: Dict[str, torch.Tensor] = {}
        if pixel_loss is not None:
            l_pix = pixel_loss(output, batch["gt"])
            l_pix, pix_logs = (l_pix if isinstance(l_pix, tuple)
                               else (l_pix, {"l_pix": l_pix}))
            total = total + l_pix
            logs.update({k: v.detach() for k, v in pix_logs.items()})
        if loss is not None:
            h_total, h_logs = loss(**hybrid_batch_kwargs(output, batch),
                                   log_sigma=state.log_sigma or None)
            total = total + h_total
            logs.update(h_logs)
        logs["l_total"] = total.detach()
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        logs["grad_norm"] = global_norm(grads).detach()
        state.optimizer.step(grads)
        state.step += 1
        return state, logs

    return train_step


def make_eval_step(net: nn.Module) -> Callable:
    """``eval_step(lq) -> output``: the forward under ``torch.no_grad`` in
    eval mode (the JAX ``deterministic=True``: no drop-path); the module's
    mode is put back afterwards."""

    @torch.no_grad()
    def eval_step(lq: torch.Tensor) -> torch.Tensor:
        was_training = net.training
        net.eval()
        try:
            return net(lq)
        finally:
            net.train(was_training)

    return eval_step
