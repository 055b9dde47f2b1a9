"""Per traced call, its wall ms less the device's busy ms inside it, mean."""

from port_bench.harness import readers


def read(run):
    return readers.host_ms_per_call(run) if run.kind == "serve" else None
