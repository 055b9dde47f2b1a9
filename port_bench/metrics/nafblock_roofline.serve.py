"""Percent: NAFBlock forward bounds over the device time of the nafblk kernels (traced calls)."""

from port_bench.harness import readers


def read(run):
    return readers.roofline(run) if run.kind == "serve" else None
