"""The square 3x3 convs' share (%) of their roofline in a train step: the sites' least
time (forward and input gradient) over the card time of the program's conv kernels
and their weight packing. Silent unless every site's every pass ran the program's kernel."""

from portbench import readers


def read(run):
    return readers.conv3x3_roofline(run, dgrad=True)
