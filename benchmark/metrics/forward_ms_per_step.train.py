"""Device ms a profiled train step under the span train.forward (the
train-mode forward)."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "train", ("train.forward",),
                          "device_ms_total")
