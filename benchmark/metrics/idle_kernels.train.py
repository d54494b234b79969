"""Share of the traced micro-steps with the card idle while the host was in the edge-chain kernel wrappers, forward or backward."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "kernels")
