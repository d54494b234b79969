"""Share of the traced sweep steps with the card idle while the host was in the edge-chain kernel wrappers."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "kernels")
