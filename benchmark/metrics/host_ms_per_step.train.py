"""The train step driver's host time a step: the median of the benchmark's own
span around each step(...) call of the window (enqueue time, no sync)."""

from benchmark.harness import readers


def read(record):
    return readers.host_ms(record, "train")
