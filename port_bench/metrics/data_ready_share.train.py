"""Percent of the items the Trainer's loader handed to its batcher whose load had finished when the training thread asked for them: loader.items_ready over loader.items (program counters)."""

from port_bench.harness import program


def read(run):
    return program.counter_share("loader.items_ready", "loader.items") if run.kind == "train" else None
