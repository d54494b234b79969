"""Share of the traced micro-steps with the card idle while the host was in the denoiser's node-level code, outside the kernel wrappers."""

from benchmark import spans


def read(run):
    return spans.idle_in(run, "denoiser")
