"""Run a function on the ranks of a fresh ``torch.distributed`` world, and
the rank workers that the tests and ``chip_smoke.py`` run there.

:func:`spawn` starts ``world`` processes (``spawn`` start method), joins
them through a ``file://`` rendezvous in a temporary directory (no port
to collide on), runs ``fn(*args)`` on each and returns every rank's
result. A rank that fails makes the parent raise with its traceback.

Workers (each returns plain Python and numpy values):

- :func:`probe_helpers` -- the mesh and multihost helpers on each rank;
- :func:`train_steps` -- data-parallel (optionally ZeRO-1) training steps
  of a network and a ``train`` block on this rank's part of a batch;
- :func:`run_trainer` -- ``Trainer(opt).train()``, then a second
  Trainer resumed from one of its checkpoints;
- :func:`spatial_run` -- the height-sharded forward (and its gradients);
  :func:`halo_rows` -- one halo exchange;
- :func:`validation_run` -- ``dist_validate`` and
  ``ImageRestorationModel.validation``;
- :func:`sequence` -- several of them in one world.

Each also runs in a single process (no world), which gives the reference
that a multi-rank run is held against. Ranks and workers run on CUDA
unless the caller passes ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lowlight_image_enhancement_tpu_torch import resolve_device


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          device: str = "cuda", args: Sequence[Any] = (),
          threads: Optional[int] = None,
          cudnn: Optional[Dict[str, bool]] = None) -> List[Any]:
    """``[fn(*args) on rank r for r in range(world)]``, each rank a new
    process joined to a world of ``world`` over ``backend`` (default
    NCCL on CUDA, gloo on the CPU), owning ``device`` (``"cuda"``:
    ``cuda:LOCAL_RANK``; two ranks on one card pass ``"cuda:0"`` and
    gloo). ``threads`` caps each rank's
    intra-op threads (CPU ranks); ``cudnn`` sets ``torch.backends.cudnn``
    flags in each rank (``allow_tf32``, ``deterministic``, ...), as the
    parent has them or not: a new process starts from PyTorch's
    defaults."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        try:
            mp.start_processes(_rank_main, nprocs=world, join=True,
                               start_method="spawn",
                               args=(fn, world, backend, device, d,
                                     tuple(args), threads, cudnn or {}))
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"a rank of the spawned world failed:\n{e}"
                               ) from None
        except mp.ProcessExitedException as e:
            raise RuntimeError(f"a rank of the spawned world died: {e}"
                               ) from None
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, d: str, args: tuple,
               threads: Optional[int], cudnn: Dict[str, bool]) -> None:
    from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
        init_multihost,
    )

    if threads:
        torch.set_num_threads(threads)
    for flag, value in cudnn.items():
        setattr(torch.backends.cudnn, flag, value)
    os.environ["LOCAL_RANK"] = str(rank)
    init_multihost(f"file://{os.path.join(d, 'rendezvous')}", world, rank,
                   backend=backend, device=device)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _launches(reset: bool = False) -> Dict[str, int]:
    """Every kernel wrapper's launch count (then set to 0 with
    ``reset``)."""
    from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
    from lowlight_image_enhancement_tpu_torch.ops import nafblock as ops
    from lowlight_image_enhancement_tpu_torch.ops import pool

    wrappers = {"nafblk_a": ops.call_a, "nafblk_b": ops.call_b,
                "nafblk_p1": ops.call_p1, "nafblk_p2": ops.call_p2,
                "ln_fwd": ln.call_ln_fwd, "ln_bwd": ln.call_ln_bwd,
                "relu_pool_fwd": pool.call_relu_pool_fwd,
                "pool_bwd": pool.call_pool_bwd}
    counts = {k: w.launches for k, w in wrappers.items()}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return counts


def _placement(spec: Dict[str, Any]):
    """``(mesh, device)``: the world's mesh and this rank's device, or no
    mesh and ``spec['device']`` (default ``cuda``) in a single process."""
    from lowlight_image_enhancement_tpu_torch.parallel.mesh import create_mesh

    if dist.is_initialized():
        mesh = create_mesh()
        return mesh, mesh.device
    return None, resolve_device(spec.get("device", "cuda"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numpy(tensors) -> List[np.ndarray]:
    """Copies (a CPU tensor's ``.numpy()`` would share its memory, which
    the optimizer then changes in place)."""
    return [t.detach().float().cpu().numpy().copy() for t in tensors]


def probe_helpers(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The helpers of ``parallel`` on this rank: ``host_info``,
    ``local_batch_slice(8)``, ``main_process_only``, a second
    ``init_multihost`` (idempotent), the mesh, this rank's
    ``shard_batch`` of ``batch``, an all-reduce of ``rank + 1`` and a
    ``replicate`` of ``rank``, both counted by
    ``compiled_collective_stats``."""
    from lowlight_image_enhancement_tpu_torch.parallel import mesh as pm
    from lowlight_image_enhancement_tpu_torch.parallel import multihost as mh
    from lowlight_image_enhancement_tpu_torch.parallel.introspect import (
        compiled_collective_stats,
    )

    group_before = dist.group.WORLD
    mh.init_multihost("127.0.0.1:1", dist.get_world_size(), dist.get_rank())
    calls = []

    @mh.main_process_only
    def record():
        calls.append(1)
        return "ran"

    mesh = pm.create_mesh()
    shard = pm.shard_batch(batch, mesh)
    total = torch.full((3,), float(mesh.index + 1), device=mesh.device)
    rep = [torch.full((2, 2), float(mesh.index), device=mesh.device)]

    def collectives():
        dist.all_reduce(total)
        pm.replicate(rep, mesh)

    stats = compiled_collective_stats(collectives)
    return {"stats": stats, "host_info": mh.host_info(),
            "local_batch_slice": mh.local_batch_slice(8),
            "main_only": (record(), calls),
            "same_group": dist.group.WORLD is group_before,
            "mesh": (mesh.size, mesh.index, str(mesh.device)),
            "shard": {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in shard.items()},
            "all_reduce": total.cpu().numpy(),
            "replicate": rep[0].cpu().numpy()}


def train_steps(spec: Dict[str, Any]) -> Dict[str, Any]:
    """``spec['steps']`` train steps of the network ``spec['network_g']``
    (weights ``spec.get('state_dict')``, else seeded random) under the
    loss and optimizer of the ``train`` block ``spec['train']``, on this
    rank's part (``shard_batch``) of the global NCHW batch
    ``spec['batch']`` (numpy).

    Under a world: the mesh's device, rank 0's weights, the step's
    gradient all-reduce and, with ``spec['zero1']``, ZeRO-1. Step
    ``spec.get('trace_step')`` runs under the profiler: its collective
    stats and the names of its device kernels. Returns the parameters
    after the steps, each step's logs, host ms and kernel launches, the
    gradients the optimizer got in the first step (``spec['grads']``),
    the optimizer state's bytes and shapes on this rank."""
    from lowlight_image_enhancement_tpu_torch.models import define_network
    from lowlight_image_enhancement_tpu_torch.parallel.introspect import (
        collective_stats,
        profile_trace,
    )
    from lowlight_image_enhancement_tpu_torch.parallel.mesh import (
        put_replicated,
        shard_batch,
    )
    from lowlight_image_enhancement_tpu_torch.parallel.zero import (
        zero1_device_put,
    )
    from lowlight_image_enhancement_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )
    from lowlight_image_enhancement_tpu_torch.training.trainer import (
        build_training_losses,
        optimizer_from_config,
    )

    mesh, device = _placement(spec)
    torch.manual_seed(0)
    net = define_network(dict(spec["network_g"]), device=device)
    if spec.get("state_dict") is not None:
        net.load_state_dict(spec["state_dict"], strict=True)
    loss, pixel_loss = build_training_losses(spec["train"], device)
    optimizer, _ = optimizer_from_config(spec["train"])
    state = create_train_state(net, optimizer, loss)
    if mesh is not None:
        put_replicated(state, mesh)
        if spec.get("zero1"):
            zero1_device_put(state, mesh)
    step = make_train_step(net, loss, optimizer, pixel_loss=pixel_loss,
                           mesh=mesh)
    if mesh is not None:
        batch = shard_batch(spec["batch"], mesh)
    else:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in spec["batch"].items()}

    grads: List[np.ndarray] = []
    if spec.get("grads"):
        apply = optimizer.step

        def capture(g):
            if not grads:
                grads.extend(_numpy(g))
            apply(g)

        optimizer.step = capture
    out: Dict[str, Any] = {"logs": [], "ms": [], "launches": [],
                           "stats": None, "device_kernels": []}
    for i in range(int(spec["steps"])):
        logs_box = {}

        def one(state=state, batch=batch):
            logs_box["logs"] = step(state, batch)[1]

        _launches(reset=True)
        _sync(device)
        t0 = time.perf_counter()
        if i == spec.get("trace_step"):
            trace = profile_trace(one, cuda=device.type == "cuda")
            out["stats"] = collective_stats(trace)
            out["device_kernels"] = sorted({
                e["name"] for e in trace["traceEvents"]
                if e.get("cat") == "kernel"})
        else:
            one()
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(_launches())
        out["logs"].append({k: float(v) for k, v in logs_box["logs"].items()})
    out.update(
        params=_numpy(optimizer.params),
        names=[k for k, _ in net.named_parameters()],
        grads=grads, state_bytes=optimizer.state_bytes(),
        moment_shapes=[tuple(t.shape) for t in (optimizer.mu or [])],
        param_shapes=[tuple(p.shape) for p in optimizer.params])
    return out


def run_trainer(opt: Dict[str, Any], resume_at: Optional[int] = None
                ) -> Dict[str, Any]:
    """``Trainer(opt).train()``; with ``resume_at``, a second Trainer then
    auto-resumes from a training-states directory of its own that holds
    a copy of that iteration's state (the first run's files stay), and
    trains to the end. Returns each run's history and last validation,
    and the optimizer state's bytes on this rank."""
    from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
        host_info,
    )
    from lowlight_image_enhancement_tpu_torch.training.checkpoint import (
        training_state_path,
    )
    from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer

    trainer = Trainer(opt)
    trainer.train()
    out = {"history": trainer.history, "val": trainer.last_val,
           "state_bytes": trainer.optimizer.state_bytes(),
           "zero1": trainer._zero1_shardings is not None,
           "step": int(trainer.state.step)}
    if resume_at is not None:
        again = copy.deepcopy(opt)
        states = os.path.abspath(opt["path"]["training_states"])
        again["path"]["training_states"] = f"{states}_resume_at_{resume_at}"
        if host_info()[2]:
            os.makedirs(again["path"]["training_states"])
            shutil.copy(training_state_path(states, resume_at),
                        again["path"]["training_states"])
        if dist.is_initialized():
            dist.barrier()
        resumed = Trainer(again)
        out["resumed_from"] = resumed.start_iter
        resumed.train()
        out["resumed_history"] = resumed.history
    return out


def spatial_run(spec: Dict[str, Any]) -> Dict[str, Any]:
    """``nafnet_apply_spatial`` of ``define_network(spec['network_g'])``
    (weights ``spec['state_dict']``) on ``spec['x']`` (numpy NCHW) over
    the world's mesh (one device without a world), under ``no_grad``
    unless ``spec['target']`` is given: then the parameter gradients of
    ``mean((out - target)^2)``, averaged over the ranks. Returns the
    output, the gradients, the K5 launches, ms and the peak memory of the
    device (CUDA)."""
    from lowlight_image_enhancement_tpu_torch.models import define_network
    from lowlight_image_enhancement_tpu_torch.ops import layernorm as ln
    from lowlight_image_enhancement_tpu_torch.parallel.mesh import (
        all_reduce_mean_,
    )
    from lowlight_image_enhancement_tpu_torch.parallel.spatial import (
        nafnet_apply_spatial,
    )

    mesh, device = _placement(spec)
    net = define_network(dict(spec["network_g"]), device=device).eval()
    net.load_state_dict(spec["state_dict"], strict=True)
    x = torch.from_numpy(np.ascontiguousarray(spec["x"])).to(device)
    target = spec.get("target")
    out: Dict[str, Any] = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ln.call_ln_fwd.launches = 0
    t0 = time.perf_counter()
    if target is None:
        with torch.no_grad():
            y = nafnet_apply_spatial(net, x, mesh)
    else:
        y = nafnet_apply_spatial(net, x, mesh)
        loss = ((y - torch.from_numpy(target).to(device)) ** 2).mean()
        params = list(net.parameters())
        grads = list(torch.autograd.grad(loss, params))
        if mesh is not None:
            all_reduce_mean_(grads, mesh)
        out["grads"] = dict(zip([k for k, _ in net.named_parameters()],
                                _numpy(grads)))
    _sync(device)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["ln_fwd_launches"] = ln.call_ln_fwd.launches
    out["out"] = y.detach().cpu().numpy()
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def halo_rows(x: np.ndarray, halo: int) -> np.ndarray:
    """``halo_exchange_rows`` of this rank's rows of ``x`` (numpy NCHW,
    its height split evenly over the world)."""
    from lowlight_image_enhancement_tpu_torch.parallel.spatial import (
        halo_exchange_rows,
    )

    mesh, _ = _placement({})
    rows = x.shape[2] // mesh.size
    mine = torch.from_numpy(np.ascontiguousarray(
        x[:, :, mesh.index * rows:(mesh.index + 1) * rows])).to(mesh.device)
    return halo_exchange_rows(mine, halo, mesh).cpu().numpy()


def sequence(calls: Sequence[Tuple[Callable, tuple]]) -> List[Any]:
    """``[fn(*args) for fn, args in calls]``: several workers in one
    spawned world."""
    return [fn(*args) for fn, args in calls]


def validation_run(spec: Dict[str, Any]) -> Dict[str, Any]:
    """``dist_validate`` of ``define_network(spec['network_g'])`` (weights
    ``spec['state_dict']``) over the batches ``spec['batches']`` (NHWC
    numpy ``lq``/``gt``) with ``spec['metrics']``, and
    ``ImageRestorationModel(spec['opt']).validation`` over the same
    batches with those weights; each rank's own image count too."""
    from lowlight_image_enhancement_tpu_torch.models import define_network
    from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
        host_info,
    )
    from lowlight_image_enhancement_tpu_torch.training.model_wrapper import (
        ImageRestorationModel,
    )
    from lowlight_image_enhancement_tpu_torch.training.train_step import (
        make_eval_step,
    )
    from lowlight_image_enhancement_tpu_torch.training.validation import (
        dist_validate,
        strided_metric_sums,
    )

    mesh, device = _placement(spec)
    net = define_network(dict(spec["network_g"]), device=device)
    net.load_state_dict(spec["state_dict"], strict=True)
    forward = make_eval_step(net)
    rank, world, _ = host_info()
    _, own = strided_metric_sums(forward, spec["batches"], spec["metrics"],
                                 device=device, rank=rank, world=world)
    results = dist_validate(forward, spec["batches"], spec["metrics"],
                            device=device)
    model = ImageRestorationModel(spec["opt"], device=device)
    model.net_g.load_state_dict(spec["state_dict"], strict=True)
    wrapper = model.validation(spec["batches"])
    return {"dist_validate": results, "own_images": own,
            "wrapper": wrapper}
