"""The square 3x3 convs' share (%) of their roofline in a predict call (forward)."""

from portbench import readers


def read(run):
    return readers.conv3x3_roofline(run, dgrad=False)
