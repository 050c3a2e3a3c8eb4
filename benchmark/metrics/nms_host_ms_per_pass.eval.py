"""Host ms a batch x pass in the span predict.nms (the multi-label NMS
loop's Python and launches) in the profiled sweep call."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "sweep", ("predict.nms",),
                          "host_ms")
