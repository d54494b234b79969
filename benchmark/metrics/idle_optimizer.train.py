"""Share of the traced micro-steps with the card idle while the host was in the trainer's optimizer span (the clip, the update and the EMA)."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "optimizer")
