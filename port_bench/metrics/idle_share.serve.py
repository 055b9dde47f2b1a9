"""Percent of the traced window (gaps between calls included) in which the device ran nothing."""

from port_bench.harness import readers


def read(run):
    return readers.idle_share(run) if run.kind == "serve" else None
