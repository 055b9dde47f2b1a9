"""Percent of the decoded pixels that were cropped: native_loader.px_cropped over px_inflated (program counters)."""

from port_bench.harness import program


def read(run):
    return program.counter_share("native_loader.px_cropped", "native_loader.px_inflated") if run.kind == "train" else None
