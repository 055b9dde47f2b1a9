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
- the update is multi-tensor: every step of it is one ``torch._foreach_*``
  op over each (device, dtype) group of leaves, with optax's constants in
  optax's order, so a step dispatches about 20 ops however many leaves
  the network has;
- mixed precision is the network's activation dtype (bf16), no scaler.

The port updates parameters and optimizer moments in place (PyTorch's
habit; the JAX step returns new arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from lowlight_image_enhancement_tpu_torch.parallel.mesh import (  # noqa: F401  (put_replicated: JAX's train_step exports it)
    BUCKET_BYTES,
    all_reduce_mean_,
    buckets,
    put_replicated,
)
from lowlight_image_enhancement_tpu_torch.training.augment import mixup_batch
from lowlight_image_enhancement_tpu_torch.utils.profiling import count, span

Batch = Mapping[str, torch.Tensor]
# Adam's denominator epsilon, added outside the square root (optax's default)
ADAM_EPS = 1e-8
# the optimizer-state leaf lists of ChainOptimizer
STATE_KEYS = ("mu", "nu", "acc")


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor, in fp32:
    one ``torch._foreach_norm`` over the leaves, then the norm of their
    norms."""
    tensors = [_fp32(t) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def _groups(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """The indices of ``tensors`` by (device, dtype), in order of first
    appearance: the lists that one multi-tensor op takes whole."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


class ChainOptimizer:
    """``[MultiSteps(] [clip_by_global_norm(max_norm) ->] AdamW | Adam | SGD
    [)]`` over a list of tensors, with optax's arithmetic.

    :meth:`init` binds the parameters and zeroes the state; :meth:`step`
    takes one gradient per parameter and updates the parameters in
    place (every ``accum_steps``-th call, with the running mean of the
    last ``accum_steps`` gradients). After :meth:`shard_` (ZeRO-1,
    ``parallel/zero.py``) the moments and the accumulator hold this rank's
    slices only.

    Each update runs one ``torch._foreach_*`` op per step of the arithmetic
    over each group of leaves that share a device and a dtype (fixed at
    :meth:`init`). :meth:`grad_norm` hands its norm to the :meth:`step` that
    follows on the same gradient list, so a train step computes one."""

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
        self.zero = None
        self._known_norm = None

    def init(self, params) -> "ChainOptimizer":
        self.params = list(params)
        self.groups = _groups(self.params)
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        self.count = 0        # updates applied (the schedule's step)
        self.mini_step = 0
        self.mu = zeros() if self.optim_type != "SGD" else None
        self.nu = zeros() if self.optim_type != "SGD" else None
        self.acc = zeros() if self.accum_steps > 1 else None
        self.zero = None      # (mesh, dim per leaf) under ZeRO-1
        return self

    # -- ZeRO-1 ---------------------------------------------------------
    def shard_(self, mesh, dims: Sequence[Optional[int]]) -> None:
        """Keep only this rank's slice, along ``dims[i]``, of leaf ``i`` of
        the moments and the accumulator (None: whole)."""
        if not mesh.distributed:
            raise ValueError("ZeRO-1 shards over the ranks of a "
                             "torch.distributed world")
        self.zero = (mesh, list(dims))
        for k in STATE_KEYS:
            full = getattr(self, k)
            if full is not None:
                setattr(self, k, [t.clone() for t in self._local(full)])

    def _local(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slices (views) of full per-leaf tensors."""
        if self.zero is None:
            return list(tensors)
        mesh, dims = self.zero
        out = []
        for t, d in zip(tensors, dims):
            if d is not None:
                k = t.shape[d] // mesh.size
                t = t.narrow(d, mesh.index * k, k)
            out.append(t)
        return out

    def _gather(self, local: Sequence[torch.Tensor],
                full: Sequence[torch.Tensor]) -> None:
        """Write every rank's slices of the sharded leaves into ``full``:
        one flat ``all_gather_into_tensor`` per bucket."""
        mesh, dims = self.zero
        n = mesh.size
        sharded = [i for i, d in enumerate(dims) if d is not None]
        for bucket in buckets([local[i] for i in sharded], BUCKET_BYTES):
            idx = [sharded[j] for j in bucket]
            send = torch.cat([local[i].reshape(-1) for i in idx])
            recv = send.new_empty(n * send.numel())
            dist.all_gather_into_tensor(recv, send, group=mesh.group)
            recv = recv.view(n, -1)
            off = 0
            for i in idx:
                k = local[i].numel()
                parts = recv[:, off:off + k].reshape(n, *local[i].shape)
                full[i].copy_(torch.cat(list(parts), dim=dims[i]))
                off += k

    def full_state(self) -> Dict[str, Optional[List[torch.Tensor]]]:
        """``mu``, ``nu``, ``acc`` at full size (gathered from every rank
        under ZeRO-1: a collective that every rank must call)."""
        out = {}
        for k in STATE_KEYS:
            lst = getattr(self, k)
            if lst is None or self.zero is None:
                out[k] = lst
                continue
            full = [torch.empty_like(p) if d is not None else t
                    for p, t, d in zip(self.params, lst, self.zero[1])]
            self._gather(lst, full)
            out[k] = full
        return out

    @torch.no_grad()
    def load_state(self, state: Mapping[str, Optional[Sequence[torch.Tensor]]]
                   ) -> None:
        """Copy full-size ``mu``/``nu``/``acc`` into the state (this rank's
        slices of them under ZeRO-1)."""
        for k in STATE_KEYS:
            if state.get(k) is not None:
                for d, s in zip(getattr(self, k), self._local(state[k])):
                    d.copy_(s)

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(t.numel() * t.element_size() for k in STATE_KEYS
                   for t in (getattr(self, k) or []))

    # -- update ---------------------------------------------------------
    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """:func:`global_norm` of the full gradient ``grads``. An
        unaccumulated :meth:`step` on this same list clips by it and
        computes no norm of its own."""
        norm = global_norm(grads)
        self._known_norm = (grads, norm)
        return norm

    def _norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of the gradient whose (local) leaves are
        ``grads``: under ZeRO-1 the sharded leaves' squares are summed
        over the ranks (one scalar all-reduce)."""
        if self.zero is None:
            return global_norm(grads)
        mesh, dims = self.zero

        def sq(ts):
            return (global_norm(ts).square() if ts
                    else torch.zeros((), device=grads[0].device))

        part = sq([g for g, d in zip(grads, dims) if d is not None])
        dist.all_reduce(part, group=mesh.group)
        return torch.sqrt(part + sq([g for g, d in zip(grads, dims)
                                     if d is None]))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        known, self._known_norm = self._known_norm, None
        if self.acc is None:
            # the clip reads the full gradient, then each rank its slices
            g_norm = None
            if self.max_norm is not None:
                g_norm = (known[1] if known is not None and known[0] is grads
                          else global_norm(grads))
            self._apply(self._local([_fp32(g) for g in grads]), g_norm)
            return
        grads = self._local([_fp32(g) for g in grads])
        n = self.mini_step
        for idx in self.groups:
            acc = [self.acc[i] for i in idx]
            delta = torch._foreach_sub([grads[i] for i in idx], acc)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(acc, delta)
        self.mini_step = (n + 1) % self.accum_steps
        if self.mini_step:
            return
        # the mean is applied in place of a copy, then the accumulator zeroed
        self._apply(self.acc, self._norm(self.acc)
                    if self.max_norm is not None else None)
        torch._foreach_zero_(self.acc)

    def _apply(self, grads: List[torch.Tensor],
               g_norm: Optional[torch.Tensor]) -> None:
        lr = float(self.schedule(self.count))
        self.count += 1
        params = self._local(self.params)
        count("train_step.optimizer_leaves", len(params))
        count("train_step.optimizer_groups", len(self.groups))
        if g_norm is not None:
            scale = torch.where(g_norm < self.max_norm,
                                torch.ones_like(g_norm),
                                self.max_norm / g_norm)
        # bias corrections in fp32, as optax computes 1 - decay**count
        one = np.float32(1.0)
        c1 = float(one - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(one - np.float32(self.b2) ** np.float32(self.count))
        for idx in self.groups:
            p, g = [params[i] for i in idx], [grads[i] for i in idx]
            if g_norm is not None:
                torch._foreach_mul_(g, scale)
            if self.optim_type == "SGD":
                torch._foreach_add_(p, g, alpha=-lr)
                continue
            m, v = [self.mu[i] for i in idx], [self.nu[i] for i in idx]
            # the decays as CPU scalar tensors of at least fp32: an in-place
            # multi-tensor multiply by them rounds as ``m.mul_(b1)`` does
            # (the CPU's by a Python float rounds b1 to a bf16 leaf's dtype)
            kind = torch.promote_types(p[0].dtype, torch.float32)
            b1, b2 = (torch.tensor(b, dtype=kind) for b in (self.b1, self.b2))
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1.0 - self.b2)
            # u = (m / c1) / (sqrt(v / c2) + eps) [+ wd * p]
            u = torch._foreach_div(m, c1)
            den = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            torch._foreach_div_(u, den)
            del den
            if self.weight_decay:
                torch._foreach_add_(u, torch._foreach_mul(
                    p, self.weight_decay))
            torch._foreach_add_(p, u, alpha=-lr)
        if self.zero is not None:
            self._gather(params, self.params)


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
                    mixup_alpha: Optional[float] = None, seed: int = 0,
                    mesh=None):
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
    inference between steps.

    With ``mesh`` (a process-group mesh, ``parallel/mesh.py``) each rank
    steps on its part of the global batch: the gradients of every
    trainable tensor are averaged over the ranks in flat buckets right
    after ``torch.autograd.grad`` (before ``grad_norm`` and the clip), and
    the logged losses with one small all-reduce, so every rank updates
    with the global gradient and logs the global-batch means (for equal
    parts and loss terms that are means over the batch, as every
    ``HybridLossPlus`` term is).

    Under a profiler the step records three spans (``utils/profiling.py``):
    ``train_step.forward`` (mixup, the network, the loss terms),
    ``train_step.backward`` (``autograd.grad``, the zero fill and, with
    ``mesh``, the all-reduces) and ``train_step.optimizer`` (``grad_norm``,
    the clip and the update), and once per applied update the counters
    ``train_step.optimizer_leaves`` and ``train_step.optimizer_groups``
    (the leaves updated; the multi-tensor groups they went through)."""
    if mesh is not None and not mesh.distributed and mesh.size > 1:
        raise ValueError(
            f"a training mesh of {mesh.size} devices in one process: launch "
            "one process per device (torchrun --nproc_per_node, "
            "parallel.init_multihost) and pass their world's mesh")
    dp = mesh is not None and mesh.distributed
    mixup_gen = (torch.Generator().manual_seed(int(seed)) if mixup_alpha
                 else None)

    def train_step(state: TrainState, batch: Batch):
        with span("train_step.forward"):
            if mixup_alpha:
                batch = mixup_batch(batch, alpha=mixup_alpha,
                                    generator=mixup_gen)
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
        with span("train_step.backward"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if dp:
                all_reduce_mean_(grads, mesh)
                logs = _mean_logs(logs, mesh)
        with span("train_step.optimizer"):
            logs["grad_norm"] = state.optimizer.grad_norm(grads).detach()
            state.optimizer.step(grads)
            state.step += 1
        return state, logs

    return train_step


def _mean_logs(logs: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """The logs' means over the ranks: one all-reduce of the stacked
    scalars."""
    keys = list(logs)
    stacked = torch.stack([logs[k].float().reshape(()) for k in keys])
    dist.all_reduce(stacked, group=mesh.group)
    stacked = stacked / mesh.size
    return dict(zip(keys, stacked.unbind()))


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
