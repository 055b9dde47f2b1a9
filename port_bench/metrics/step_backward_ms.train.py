"""Host ms of a traced step's backward: autograd.grad and the zero fill (train_step.backward, a program span)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("train_step.backward",)) if run.kind == "train" else None
