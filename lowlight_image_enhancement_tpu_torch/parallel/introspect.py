"""Collective structure of a step, read from a ``torch.profiler`` trace.

Counterpart of ``lowlight_image_enhancement_tpu/parallel/introspect.py``,
which reads the collectives XLA put into a compiled program. The port's
collectives are c10d calls; every one of them, the port's own and any
library's, passes through a ``c10d::`` dispatcher op that the profiler
records on the calling thread with its arguments' shapes, on every
backend (``c10d::allreduce_``, ``c10d::_allgather_base_`` for
``all_gather_into_tensor``, ...). The backends add their own records
(``gloo:all_reduce``, ``nccl:all_reduce``) on their threads; those are
not counted, so each call counts once.

- :func:`collective_stats` -- per-kind ``{count, bytes, shapes}`` of the
  collectives in a Chrome trace (``export_chrome_trace``);
- :func:`compiled_collective_stats` -- run a step once under the profiler
  and return its stats (:func:`profile_trace` gives the trace itself);
- :func:`bulk_and_scalar` -- split each kind into bulk (gradients,
  parameters) and scalar collectives.

``bytes`` sums each call's first tensor argument where the record shows
it (the in-place buffer of all_reduce and broadcast, the output of
``all_gather_into_tensor``), else its first recorded tensor argument;
a tensor list carries no dtype in the record and counts at 4 bytes an
element.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Mapping, Union

import torch

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# the profiler's type names -> the HLO-style names of the shape strings
_TYPES = {"float": "f32", "double": "f64", "c10::BFloat16": "bf16",
          "c10::Half": "f16", "int": "s32", "long int": "s64",
          "short int": "s16", "signed char": "s8", "unsigned char": "u8",
          "bool": "pred", "TensorList": "f32"}

# c10d dispatcher ops -> collective kind (JAX's names where XLA has one)
KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter", "send": "send", "recv_": "recv",
    "recv_any_source_": "recv", "barrier": "barrier",
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _shape_text(dims: Any, typ: str) -> str:
    """``f32[2000]`` for a tensor, ``(f32[4], f32[4])`` for a list."""
    t = _TYPES.get(typ, "f32")
    if dims and isinstance(dims[0], list):
        parts = [f"{t}[{','.join(map(str, d))}]" for d in dims]
        return parts[0] if len(parts) == 1 else f"({', '.join(parts)})"
    return f"{t}[{','.join(map(str, dims))}]"


def _payload(args: Mapping[str, Any]) -> str:
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    for i, d in enumerate(dims):
        if d:
            return _shape_text(d, types[i] if i < len(types) else "")
    return "f32[0]"


def collective_stats(trace: Union[str, Mapping[str, Any]]
                     ) -> Dict[str, Dict[str, Any]]:
    """Per-kind ``{count, bytes, shapes}`` of the c10d collectives in a
    Chrome trace (a path or its parsed JSON)."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    stats: Dict[str, Dict[str, Any]] = {}
    for ev in trace.get("traceEvents", []):
        name = ev.get("name", "")
        if ev.get("ph") != "X" or not name.startswith("c10d::"):
            continue
        op = name[len("c10d::"):]
        kind = KINDS.get(op, op.strip("_"))
        shape = _payload(ev.get("args") or {})
        entry = stats.setdefault(kind, {"count": 0, "bytes": 0,
                                        "shapes": []})
        entry["count"] += 1
        entry["bytes"] += _shape_bytes(shape)
        entry["shapes"].append(shape)
    return stats


def profile_trace(fn, *args, cuda: bool = False) -> Dict[str, Any]:
    """The parsed Chrome trace of one ``fn(*args)`` under
    ``torch.profiler`` (host operators with their shapes; with ``cuda``
    the card's kernels too)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=True) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def compiled_collective_stats(step, *args) -> Dict[str, Dict[str, Any]]:
    """Run ``step(*args)`` once under ``torch.profiler`` (the step's state
    advances) and return its collective stats."""
    return collective_stats(profile_trace(step, *args))


def bulk_and_scalar(stats: Dict[str, Dict[str, Any]],
                    bulk_threshold_bytes: int = 4096):
    """Split a kind's stats into bulk (>= threshold) and scalar/control
    collectives -- the invariant worth pinning is about the BULK ones
    (gradients, parameters), while tiny scalar reductions (loss logs) are
    free."""
    out = {}
    for kind, entry in stats.items():
        bulk = [s for s in entry["shapes"]
                if _shape_bytes(s) >= bulk_threshold_bytes]
        scalar = [s for s in entry["shapes"]
                  if _shape_bytes(s) < bulk_threshold_bytes]
        out[kind] = {
            "bulk_count": len(bulk),
            "bulk_bytes": sum(_shape_bytes(s) for s in bulk),
            "scalar_count": len(scalar),
        }
    return out
