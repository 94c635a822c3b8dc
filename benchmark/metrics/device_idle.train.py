"""The share of the traced trainer steps' wall time in which no operation ran
on the card, in percent."""

from benchmark.harness.roofline import idle


def read(run):
    return idle(run)
