"""Host ms a traced call spends in the tiles' overlap-add and final divide: validation.blend (program spans)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("validation.blend",)) if run.kind == "serve" else None
