"""Host ms of a traced step's optimizer: grad_norm, the clip and the update (train_step.optimizer, a program span)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("train_step.optimizer",)) if run.kind == "train" else None
