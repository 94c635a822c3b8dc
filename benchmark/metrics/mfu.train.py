"""The share of the card's dense bf16 peak that the train step reaches
through the trainer, in percent."""

from benchmark.harness.roofline import mfu


def read(run):
    return mfu(run)
