"""Host ms inside the step_fn call (forward, backward and optimizer enqueued), mean over the window."""

from port_bench.harness import readers


def read(run):
    return readers.mean_ms([u.end - u.start for u in run.units]) if run.kind == "train" else None
