"""ZeRO-1: the optimizer state sharded over the data-parallel ranks.

Counterpart of ``lowlight_image_enhancement_tpu/parallel/zero.py``. The
JAX package pins a ``NamedSharding`` on every optimizer-state leaf and
lets XLA partition the update and insert the parameter all-gather. The
port does the same by hand in ``ChainOptimizer``
(``training/train_step.py``):

- each moment leaf (``mu``, ``nu`` and the ``MultiSteps`` accumulator) is
  cut along its largest dimension that the world size divides (JAX's
  ``_leaf_spec`` rule); a leaf with none stays whole on every rank;
- the step clips with the full, all-reduced gradient, then each rank
  updates only its slice of every sharded leaf (parameter, gradient and
  moments sliced alike) and the full parameters are rebuilt with one flat
  ``all_gather_into_tensor`` per bucket;
- a checkpoint gathers the moments first, so it is the file a replicated
  run writes; a restore cuts them again.

AdamW is elementwise, so the numbers equal replicated training.
``torch.distributed.optim.ZeroRedundancyOptimizer`` is no counterpart:
``ChainOptimizer`` (optax's arithmetic) is no ``torch.optim.Optimizer``,
and it partitions whole parameters where JAX cuts each leaf.

Usage::

    mesh = create_mesh()              # under init_multihost
    state = create_train_state(net, optimizer, loss)
    state, shardings = zero1_device_put(state, mesh)
    step = make_train_step(net, loss, optimizer, mesh=mesh)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["zero1_shardings", "zero1_device_put", "leaf_dim"]


def leaf_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is cut along over ``n`` ranks:
    the largest that ``n`` divides (the first of equals), else None."""
    best_dim, best_size = None, 0
    for d, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best_dim, best_size = d, s
    return best_dim


def zero1_shardings(state, mesh) -> Dict[str, List[Optional[int]]]:
    """Per optimizer-state leaf list (``mu``, ``nu``, ``acc`` where the
    optimizer has it) the dimension each leaf is sharded on, None for a
    leaf that stays whole."""
    opt = state.optimizer
    dims = [leaf_dim(tuple(p.shape), mesh.size) for p in opt.params]
    return {k: list(dims) for k in ("mu", "nu", "acc")
            if getattr(opt, k) is not None}


def zero1_device_put(state, mesh) -> Tuple[object, Dict]:
    """Cut ``state``'s optimizer moments down to this rank's slices (the
    optimizer then updates and gathers by them). Returns
    ``(state, shardings)``."""
    shardings = zero1_shardings(state, mesh)
    if shardings:
        state.optimizer.shard_(mesh, next(iter(shardings.values())))
    return state, shardings
