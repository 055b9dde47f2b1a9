"""Set-up seconds: start of the run to the end of the warm-up (host clock)."""


def read(run):
    return run.setup_s
