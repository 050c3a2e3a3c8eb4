"""Host ms a batch x pass in the spans sweep.collect (the detections made
COCO records) and sweep.score (the COCO scorer) in the profiled sweep
call."""

from benchmark.harness import spans


def read(record):
    return spans.per_unit(record, "sweep", ("sweep.collect", "sweep.score"),
                          "host_ms")
