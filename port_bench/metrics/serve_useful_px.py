"""Percent of the pixels the server ran that were input: serving.px_in over serving.px_run (program counters)."""

from port_bench.harness import program


def read(run):
    return program.counter_share("serving.px_in", "serving.px_run") if run.kind == "serve" else None
