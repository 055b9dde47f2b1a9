"""Percent of the bf16 peak: 3x the network's forward FLOPs a step over the window's step time."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run) if run.kind == "train" else None
