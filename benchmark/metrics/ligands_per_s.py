"""Ligands returned per second: whole batches and the batch in flight by its share of forwards, over the window."""

from benchmark import readers


def read(run):
    return readers.rate(run, "ligands")
