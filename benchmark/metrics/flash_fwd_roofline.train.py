"""The attention forward's least time over its device time, in percent,
over the traced steps of the trainer's loop (the forward and its recompute)."""

from benchmark.harness.roofline import share


def read(run):
    return share(run, "fwd")
