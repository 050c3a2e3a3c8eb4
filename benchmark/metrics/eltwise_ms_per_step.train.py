"""Device ms a step of PyTorch's elementwise and reduction kernels (train-mode
BatchNorm, activations, optimizer and EMA), over the profiled steps."""

from benchmark.harness import readers


def read(record):
    return readers.elementwise_ms(record, "train")
