"""Percent: NAFBlock forward and backward bounds over the device time of the nafblk kernels (traced steps)."""

from port_bench.harness import readers


def read(run):
    return readers.roofline(run) if run.kind == "train" else None
