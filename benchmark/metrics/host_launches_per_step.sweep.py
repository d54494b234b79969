"""CUDA runtime launch calls per sweep step."""

from benchmark import readers


def read(run):
    return readers.launches_per_step(run)
