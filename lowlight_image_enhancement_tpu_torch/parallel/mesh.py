"""Data-parallel mesh over a ``torch.distributed`` world or over the local
devices of one process.

Counterpart of ``lowlight_image_enhancement_tpu/parallel/mesh.py``. JAX
runs one process over a ``Mesh`` of devices and lets XLA insert the
gradient all-reduce into the jitted step. The port has two kinds of mesh:

- **a process-group mesh** (training, validation, the spatial forward):
  the ``torch.distributed`` world, one process per device; the mesh knows
  every rank's device and this rank's index. :func:`shard_batch` gives
  this rank its slice of a global batch, :func:`replicate` broadcasts
  rank 0's tensors, :func:`all_reduce_mean_` averages the gradients;
- **an in-process mesh** (serving and export): a list of local devices,
  each holding a replica; a batch is split along dim 0 across them and
  needs no collective. Training refuses it: it runs one process per
  device.

The gradient reduction is explicit and not ``DistributedDataParallel``:
the port's step takes its gradients with ``torch.autograd.grad``, which
DDP's reducer never sees, and ``log_sigma`` is no module parameter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from lowlight_image_enhancement_tpu_torch import resolve_device
from lowlight_image_enhancement_tpu_torch.parallel.multihost import (
    rank_device,
)

# DistributedDataParallel's default bucket (bucket_cap_mb=25)
BUCKET_BYTES = 25 * 2 ** 20


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` along ``axis_name``; ``group`` is the
    process group (None for an in-process mesh) and ``index`` this
    process's position on the axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"
    group: Any = None
    index: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device (an in-process mesh: its first)."""
        return self.devices[self.index]

    @property
    def distributed(self) -> bool:
        return self.group is not None


def create_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
                devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A 1-D data-parallel mesh.

    Under a ``torch.distributed`` world: the world, this rank owning
    ``devices[0]`` if given, else :func:`..multihost.rank_device`.
    Otherwise: ``devices`` (default every visible CUDA device) in this
    process, the first ``n_devices`` of them."""
    if dist.is_available() and dist.is_initialized():
        if devices is not None and len(devices) > 1:
            raise ValueError(
                "a process of a torch.distributed world owns one device; "
                "launch one process per device (torchrun --nproc_per_node)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"requested {n_devices} devices, only {world} available"
                if n_devices > world else
                f"requested {n_devices} devices: a mesh spans the whole "
                f"world of {world} processes")
        own = torch.device(devices[0]) if devices else rank_device()
        names: List[Optional[str]] = [None] * world
        dist.all_gather_object(names, str(own))
        return Mesh(tuple(torch.device(d) for d in names), axis_name,
                    dist.group.WORLD, rank)
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis_name)


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, float, int))


def _part(x: Any, n: int, i: int, device: torch.device) -> Any:
    """Slice ``i`` of ``n`` of ``x``'s leading axis on ``device``; an axis
    that does not divide, and a scalar, whole (replicated)."""
    if not _is_array(x):
        return x
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    if t.dim() >= 1 and t.shape[0] % n == 0:
        per = t.shape[0] // n
        t = t[i * per:(i + 1) * per]
    return t.to(device)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh
                ) -> Union[Dict[str, Any], List[Dict[str, Any]]]:
    """A global batch dict split along its leading axis over ``mesh``
    (JAX's ``shard_batch``): leading axes that divide the mesh size are
    sliced, others and scalars are replicated, values move to the device
    as tensors (non-numeric values pass as they are).

    A process-group mesh returns this rank's dict; an in-process mesh a
    list of one dict per device."""
    n = mesh.size
    if mesh.distributed:
        return {k: _part(v, n, mesh.index, mesh.device)
                for k, v in batch.items()}
    return [{k: _part(v, n, i, dev) for k, v in batch.items()}
            for i, dev in enumerate(mesh.devices)]


def buckets(tensors: Sequence[torch.Tensor], cap: int) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive groups of at most ``cap``
    bytes in fp32; a larger tensor alone."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * 4
        if not out or size + nbytes > cap:
            out.append([])
            size = 0
        out[-1].append(i)
        size += nbytes
    return out


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh
              ) -> List[torch.Tensor]:
    """Broadcast rank 0's values of ``tensors`` into every rank's, in
    place (one flat buffer per dtype). Identity off a process group."""
    tensors = list(tensors)
    if not mesh.distributed or mesh.size == 1:
        return tensors
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, 0, group=mesh.group)
        _unpack(flat, group)
    return tensors


def put_replicated(state, mesh: Mesh):
    """Every rank starts from rank 0's parameters and buffers (JAX's
    ``put_replicated``): the network's state and ``log_sigma``."""
    replicate(list(state.model.state_dict().values())
              + list(state.log_sigma.values()), mesh)
    return state


def _unpack(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh
                     ) -> List[torch.Tensor]:
    """Average ``tensors`` over the ranks, in place: packed into flat fp32
    buffers of at most ``BUCKET_BYTES`` (DDP's default bucket), one
    ``all_reduce`` each, divided by the world size. Identity off a
    process group."""
    tensors = list(tensors)
    if not mesh.distributed:
        return tensors
    for idx in buckets(tensors, BUCKET_BYTES):
        group = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1).float() for t in group])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        _unpack(flat, group)
    return tensors
