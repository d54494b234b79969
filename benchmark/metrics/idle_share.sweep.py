"""Share of the traced sweep steps with the card idle."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
