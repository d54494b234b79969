"""The training step's model FLOPs (three forwards) over the untraced time, at the precision's peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
