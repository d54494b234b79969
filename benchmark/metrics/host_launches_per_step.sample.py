"""CUDA runtime launch calls per sampling step."""

from benchmark import readers


def read(run):
    return readers.launches_per_step(run)
