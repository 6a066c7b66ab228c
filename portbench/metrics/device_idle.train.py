"""Share (%) of the profiled stretch of train chunks in which nothing ran on the card."""

from portbench import readers


def read(run):
    return readers.idle(run)
