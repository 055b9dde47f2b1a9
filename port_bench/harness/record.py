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
from typing import Any, Dict, List, Optional, Tuple

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
    setup_s: float = 0.0
    units: List[Unit] = field(default_factory=list)
    window_s: float = 0.0
    forwards: List[Tuple[int, ...]] = field(default_factory=list)
    step_shape: Optional[Tuple[int, ...]] = None
    traced: List[Unit] = field(default_factory=list)
    trace: Optional[Trace] = None
    block_calls: List[Tuple[int, int, int, int, bool]] = field(
        default_factory=list)
    memory_peak_bytes: int = 0


class Hooks:
    """Forward hooks on the model (the ``model.forward`` span; the input
    shape of each forward) and on its NAFBlocks (each call's shape and
    whether it will run backward), on while ``counting`` / ``tracing``."""

    def __init__(self, model: torch.nn.Module, run: Run, spans: Spans):
        self.run, self.spans = run, spans
        self.counting = False
        self.tracing = False
        self.handles = [
            model.register_forward_pre_hook(self._pre),
            model.register_forward_hook(self._post)]
        for m in model.modules():
            if type(m).__name__ == "NAFBlock":
                self.handles.append(m.register_forward_pre_hook(self._block))

    def _pre(self, module, args):
        if self.counting:
            self.run.forwards.append(tuple(args[0].shape))
        self.spans.enter("model.forward")

    def _post(self, module, args, out):
        self.spans.exit("model.forward")

    def _block(self, module, args):
        if self.tracing:
            n, c, h, w = args[0].shape
            self.run.block_calls.append(
                (n, c, h, w, torch.is_grad_enabled() and module.training))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
