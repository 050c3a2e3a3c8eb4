"""The hand kernels' share of their roofline in the profiled steps (%)."""

from benchmark.harness import readers


def read(record):
    return readers.kernel_roofline(record, "train")
