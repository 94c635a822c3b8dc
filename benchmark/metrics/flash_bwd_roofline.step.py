"""The attention backward's (dQ and dK/dV together) least time over its
device time, in percent, over the traced steps called directly."""

from benchmark.harness.roofline import share


def read(run):
    return share(run, "bwd")
