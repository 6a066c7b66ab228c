"""The 2x upsamples' share (%) of their roofline in a train step, forward and backward."""

from portbench import readers


def read(run):
    return readers.upsample_roofline(run, backward=True)
