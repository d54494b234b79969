"""Both backward edge-chain kernels' share of their roofline while training."""

from benchmark import readers


def read(run):
    return readers.roofline(run, readers.BWD_KERNELS, run.bwd_least_s)
