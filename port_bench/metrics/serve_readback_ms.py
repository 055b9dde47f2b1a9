"""Host ms a traced call spends reading its output back: serving.d2h + serving.gather (program spans)."""

from port_bench.harness import program


def read(run):
    return program.ms_per_unit(run, ("serving.d2h", "serving.gather")) if run.kind == "serve" else None
