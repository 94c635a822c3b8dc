"""The attention backward's (dQ and dK/dV together) least time over its
device time, in percent, over the traced steps of the trainer's loop."""

from benchmark.harness.roofline import share


def read(run):
    return share(run, "bwd")
