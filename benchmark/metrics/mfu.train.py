"""The whole step's share of the card's peak over the window (%): the plain
model's forward and backward FLOPs a step times the steps, at the peak of
the configuration's precision, over the window."""

from benchmark.harness import readers


def read(record):
    return readers.mfu(record, "train")
