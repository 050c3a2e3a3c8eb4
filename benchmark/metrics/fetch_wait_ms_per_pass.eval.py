"""Host ms a batch x pass in the span sweep.fetch (the host waiting for a
batch's detections) in the profiled sweep call."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "sweep", ("sweep.fetch",),
                          "host_ms")
