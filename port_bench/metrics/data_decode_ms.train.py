"""Host ms a traced step spends decoding crops: native_loader.decode (program spans), per trainer.step."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("native_loader.decode",)) if run.kind == "train" else None
