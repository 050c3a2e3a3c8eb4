"""Device ms a profiled train step under the span train.loss (decode, TAL
in train.assign, BCE, CIoU, DFL)."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "train", ("train.loss",),
                          "device_ms_total")
