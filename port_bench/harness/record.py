"""What one run hands to the metric readers, and the hooks that fill it.

A run has a measured window of ``units`` (a served call or a training
step, host clock), optionally followed by a traced tail of more units
under the profiler. Host metrics read the window; device metrics read the
tail's trace, whose window spans exactly the traced units and the gaps
between them.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from functools import partial
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from port_bench.harness.trace import Spans, Trace


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"port_bench [{time.perf_counter() - T_START:9.3f} s] {msg}",
          file=sys.stderr, flush=True)


@dataclass
class Unit:
    start: float          # host clock, s
    end: float
    pixels: int = 0       # input pixels of a served call
    wait: float = 0.0     # host time before the unit: the step's data wait


@dataclass
class Run:
    kind: str                                  # "serve" | "train"
    dtype: str                                 # activation dtype
    net: Dict[str, Any]                        # network_g
    reference: Optional[ModuleType] = None     # its plain reference
    setup_s: float = 0.0
    units: List[Unit] = field(default_factory=list)
    window_s: float = 0.0
    forwards: List[Tuple[int, ...]] = field(default_factory=list)
    step_shape: Optional[Tuple[int, ...]] = None
    traced: List[Unit] = field(default_factory=list)
    trace: Optional[Trace] = None
    # traced calls by port module class: the reference's record of each
    # call, and whether it will run backward
    calls: Dict[str, List[tuple]] = field(default_factory=dict)
    memory_peak_bytes: int = 0


class Hooks:
    """Forward hooks on the model (the ``model.forward`` span; the input
    shape of each forward) and on its modules of each class that the
    run's reference names in ``counted`` (the reference's record of each
    call, and whether it will run backward), on while ``counting`` /
    ``tracing``."""

    def __init__(self, model: torch.nn.Module, run: Run, spans: Spans):
        self.run, self.spans = run, spans
        counted: Dict[str, Callable[[tuple], tuple]] = getattr(
            run.reference, "counted", {})
        self.counting = False
        self.tracing = False
        self.handles = [
            model.register_forward_pre_hook(self._pre),
            model.register_forward_hook(self._post)]
        for m in model.modules():
            cls = type(m).__name__
            if cls in counted:
                self.handles.append(m.register_forward_pre_hook(
                    partial(self._call, cls, counted[cls])))

    def _pre(self, module, args):
        if self.counting:
            self.run.forwards.append(tuple(args[0].shape))
        self.spans.enter("model.forward")

    def _post(self, module, args, out):
        self.spans.exit("model.forward")

    def _call(self, cls, record, module, args):
        if self.tracing:
            self.run.calls.setdefault(cls, []).append(
                (*record(args), torch.is_grad_enabled() and module.training))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
