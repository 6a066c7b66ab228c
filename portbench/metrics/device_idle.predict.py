"""Share (%) of the profiled stretch of predict calls in which nothing ran on the card."""

from portbench import readers


def read(run):
    return readers.idle(run)
