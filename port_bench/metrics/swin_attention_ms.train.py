"""Device ms a traced step in the window-attention core, forward and backward (program spans swinir.attention and swinir.attention_bwd)."""

from port_bench.harness import window_counts


def read(run):
    return window_counts.attention_ms(run) if run.kind == "train" else None
