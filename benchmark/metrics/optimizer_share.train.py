"""Share of the traced micro-steps' wall time in the trainer's own optimizer span."""

from benchmark import readers


def read(run):
    return readers.span_share(run, "optimizer")
