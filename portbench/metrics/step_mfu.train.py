"""The window's share (%) of the card's dense peak: model operations per image (3 forwards
for a train step) x images per second, over bf16's peak (TF32's for float32 cells)."""

from portbench import readers


def read(run):
    return readers.mfu(run, passes=3)
