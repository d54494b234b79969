"""The sampler's denoiser FLOPs over the untraced time, at the precision's peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
