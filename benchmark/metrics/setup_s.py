"""Process start to the first timed batch or micro-step."""


def read(run):
    return run.setup_s
