"""Share of the traced micro-steps with the card idle."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
