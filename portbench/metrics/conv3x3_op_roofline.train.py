"""The square 3x3 convs' share (%) of their roofline in a train step, counted at the
operators: the sites' least time (forward and input gradient) over the card time of every
operation launched inside the program's ``op.conv3x3`` and ``op.conv3x3_dgrad`` spans, the
weights' packing included. Silent unless the spans number steps x sites, each."""

from portbench import program_spans


def read(run):
    return program_spans.conv3x3_op_roofline(run)
