"""Device ms a profiled train step under the span train.backward (autograd's
kernels, launched from its own thread while the span is open)."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "train", ("train.backward",),
                          "device_ms_total")
