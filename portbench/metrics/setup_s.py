"""``setup_s``: process start to the first timed call (host clock)."""


def read(run):
    return run.setup_s
