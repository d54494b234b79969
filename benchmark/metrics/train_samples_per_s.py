"""Ligand-pocket pairs through forward, backward and the optimizer per second, over the window."""

from benchmark import readers


def read(run):
    return readers.rate(run, "samples")
