"""Device ms a batch x pass under the span sweep.restore (pad, the U-Net,
crop) in the profiled sweep call."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "sweep", ("sweep.restore",),
                          "device_ms_total")
