"""The card's idle share of the profiled sweep call's wall time (%)."""

from benchmark.harness import readers


def read(record):
    return readers.idle_share(record, "sweep")
