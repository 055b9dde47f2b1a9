"""Training step, ms: the window's wall time over the steps it completed, ending in a synchronize."""

from port_bench.harness import readers


def read(run):
    return readers.step_ms(run)
