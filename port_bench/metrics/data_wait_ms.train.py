"""Host ms from one step_fn return to the next call (the Trainer's data_time), mean over the window."""

from port_bench.harness import readers


def read(run):
    return readers.mean_ms([u.wait for u in run.units]) if run.kind == "train" else None
