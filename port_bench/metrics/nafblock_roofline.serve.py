"""Percent: NAFBlock forward bounds over the device time of the nafblk kernels (traced calls)."""

from port_bench.harness import counts, readers


def read(run):
    return readers.roofline(run, "NAFBlock", "nafblk::", counts.block_bound_s) if run.kind == "serve" else None
