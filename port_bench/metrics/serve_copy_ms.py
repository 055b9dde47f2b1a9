"""Device ms of host-device copies per input Mpix (traced calls)."""

from port_bench.harness import readers


def read(run):
    return readers.copy_ms_per_mpix(run) if run.kind == "serve" else None
