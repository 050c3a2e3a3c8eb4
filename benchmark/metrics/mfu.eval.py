"""The sweep's share of the card's peak over the window (%): the detector's
forward FLOPs an image-pass at the peak of its precision, plus the U-Net's
forward FLOPs a restored image at the peak of its precision, over the
window."""

from benchmark.harness import readers


def read(record):
    return readers.mfu(record, "sweep")
