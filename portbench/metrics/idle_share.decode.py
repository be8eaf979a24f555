"""``idle_share.decode`` (device): the share of the traced window in which
no device activity (kernel, copy, memset) ran, in %."""

from portbench.harness.roofline import idle_share


def read(run):
    return idle_share(run)
