"""Share of the traced sweep steps with the card idle while the host was in the sampler's own step code or decode."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "sampler")
