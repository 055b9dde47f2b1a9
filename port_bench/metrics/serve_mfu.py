"""Percent of the bf16 peak: forward FLOPs of the batches the server ran over the window."""

from port_bench.harness import readers


def read(run):
    return readers.mfu(run) if run.kind == "serve" else None
