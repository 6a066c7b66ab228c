"""The window's share (%) of the card's dense peak in prediction: one forward per image."""

from portbench import readers


def read(run):
    return readers.mfu(run, passes=1)
