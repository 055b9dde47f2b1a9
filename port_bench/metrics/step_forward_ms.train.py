"""Host ms of a traced step's forward: mixup, the net and the loss terms (train_step.forward, a program span)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("train_step.forward",)) if run.kind == "train" else None
