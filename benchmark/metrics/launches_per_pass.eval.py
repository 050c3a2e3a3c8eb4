"""Kernel launches a (batch x pass) in the profiled sweep call."""

from benchmark.harness import readers


def read(record):
    return readers.launches(record, "sweep")
