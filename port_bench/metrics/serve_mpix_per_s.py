"""Input Mpix of all completed calls over the time from the first call's start to the last call's end."""

from port_bench.harness import readers


def read(run):
    return readers.rate(run)
