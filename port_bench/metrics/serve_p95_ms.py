"""95th percentile (nearest rank) of the wall time of every call completed in the window, ms."""

from port_bench.harness import readers


def read(run):
    return readers.percentile([(u.end - u.start) * 1e3 for u in run.units], 95) if run.units else None
