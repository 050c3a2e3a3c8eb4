"""Kernel launches (the launch API's events) a step, over the profiled
steps."""

from benchmark.harness import readers


def read(record):
    return readers.launches(record, "train")
