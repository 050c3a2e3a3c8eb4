"""The card's idle share of the profiled steps' wall time (%)."""

from benchmark.harness import readers


def read(record):
    return readers.idle_share(record, "train")
