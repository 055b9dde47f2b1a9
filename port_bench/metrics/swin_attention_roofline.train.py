"""Percent: the window-attention core's least time (swinir.windows, counted from the math) over its device time in the program's spans (traced steps)."""

from port_bench.harness import window_counts


def read(run):
    return window_counts.attention_roofline(run) if run.kind == "train" else None
