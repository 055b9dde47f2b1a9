"""Process-group glue: one process per device.

Counterpart of ``lowlight_image_enhancement_tpu/parallel/multihost.py``
(reference ``basicsr/utils/dist_util.py:17-65``). JAX initialises one
runtime per host and addresses every local device from it; PyTorch runs
one process per device (``torchrun``), joined in a ``torch.distributed``
world:

- :func:`init_multihost` -- make the world from torchrun's
  ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``,
  from SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID``, or
  from explicit arguments; a no-op for a single process, idempotent;
- :func:`rank_device` -- the device this process owns;
- :func:`host_info`, :func:`local_batch_slice`, :func:`main_process_only`
  -- JAX's names and contracts over the world's rank and size.

Backend by device: NCCL for a CUDA rank, gloo for a CPU rank; ``backend``
overrides it (the reference's ``dist_params.backend``). Two ranks on one
card need gloo, since NCCL refuses two ranks on one GPU: the caller passes
it, nothing retries.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from lowlight_image_enhancement_tpu_torch import resolve_device

_DEVICE: Optional[torch.device] = None


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _coordinator_from_env() -> Optional[str]:
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return None


def _own_device(device: Any, local_rank: int) -> torch.device:
    """``device`` None or ``"cuda"``: ``cuda:local_rank`` (raises where
    CUDA is absent); an indexed device, or the CPU, as given."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local_rank} has no CUDA device of its own "
                f"({torch.cuda.device_count()} visible): pass device= and a "
                "backend that shares one (gloo)")
        dev = torch.device("cuda", local_rank)
    return dev


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: Any = None) -> None:
    """Join this process to a ``torch.distributed`` world (no-op for a
    single process or when the world already exists).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a URL
    (``tcp://...``, ``file://...``); without it, torchrun's
    ``MASTER_ADDR:MASTER_PORT`` is used. ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE``/``RANK`` or SLURM's
    ``SLURM_NTASKS``/``SLURM_PROCID``. ``device`` is the device this rank
    owns (default ``cuda:LOCAL_RANK``; ``"cpu"`` only when asked for); it
    is made the current CUDA device before the process group.
    """
    global _DEVICE
    coordinator_address = coordinator_address or _coordinator_from_env()
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int("RANK", "SLURM_PROCID")
    if coordinator_address is None and num_processes in (None, 1):
        return  # single process
    if dist.is_initialized():
        return  # idempotent second call
    if (coordinator_address is None or num_processes is None
            or process_id is None):
        raise ValueError("init_multihost needs a coordinator address "
                         "(MASTER_ADDR and MASTER_PORT), the world size and "
                         "this process's rank (arguments, torchrun's or "
                         "SLURM's environment)")
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if local_rank is None:
        local_rank = process_id % max(torch.cuda.device_count(), 1)
    dev = _own_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _DEVICE = dev


def rank_device() -> torch.device:
    """The device this process owns: the one :func:`init_multihost` set;
    else the current CUDA device (raises where CUDA is absent)."""
    if _DEVICE is not None and dist.is_initialized():
        return _DEVICE
    resolve_device("cuda")
    return torch.device("cuda", torch.cuda.current_device())


def host_info() -> Tuple[int, int, bool]:
    """-> (process_index, process_count, is_main_process)."""
    if not dist.is_initialized():
        return 0, 1, True
    idx, cnt = dist.get_rank(), dist.get_world_size()
    return idx, cnt, idx == 0


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """-> (local_batch_size, offset) of this process's part of the batch."""
    idx, cnt, _ = host_info()
    if global_batch % cnt != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {cnt} hosts")
    per = global_batch // cnt
    return per, idx * per


def main_process_only(fn: Callable) -> Callable:
    """Run ``fn`` only on process 0 (reference ``@master_only``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if host_info()[2]:
            return fn(*args, **kwargs)
        return None

    return wrapper
