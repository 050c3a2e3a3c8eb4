"""Device ms a profiled train step under the span train.augment (the bf16
cast, HSV, flip, the corruption draws and K1, /255)."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "train", ("train.augment",),
                          "device_ms_total")
