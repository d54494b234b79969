"""Share of the traced micro-steps with the card idle while the host was in the trainer's backward span, outside the kernels' backward wrappers."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "autograd")
