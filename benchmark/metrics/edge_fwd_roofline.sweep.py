"""Both forward edge-chain kernels' share of their roofline in the test-set sweep."""

from benchmark import readers


def read(run):
    return readers.roofline(run, readers.FWD_KERNELS, run.fwd_least_s)
