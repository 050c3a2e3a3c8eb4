"""The whole train step's pace with the host's stalls left out: the median
of the window's step times (the gaps between the CUDA events recorded after
consecutive steps). It stands beside train_images_per_s and
train_step_ms_p90, which a stall of the host moves."""

from benchmark.harness import readers


def read(record):
    return readers.step_ms_median(record, "train")
