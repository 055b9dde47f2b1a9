"""Host ms a traced call spends staging its input: serving.pad + serving.h2d + validation.tiles (program spans)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("serving.pad", "serving.h2d", "validation.tiles")) if run.kind == "serve" else None
