"""CUDA runtime launch calls per whole sampler.step span of the sweep."""

from benchmark import spans


def read(run):
    return spans.launches_per_span(run, "sampler.step")
