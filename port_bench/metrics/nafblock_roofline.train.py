"""Percent: NAFBlock forward and backward bounds over the device time of the nafblk kernels (traced steps)."""

from port_bench.harness import counts, readers


def read(run):
    return readers.roofline(run, "NAFBlock", "nafblk::", counts.block_bound_s) if run.kind == "train" else None
