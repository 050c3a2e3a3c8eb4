"""Device ms a profiled train step under the spans train.optimizer (the
gradient norm, SGD, the schedule) and train.ema (the EMA loop)."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "train", ("train.optimizer", "train.ema"),
                          "device_ms_total")
