"""Percent of the traced window (gaps between steps included) in which the device ran nothing."""

from port_bench.harness import readers


def read(run):
    return readers.idle_share(run) if run.kind == "train" else None
