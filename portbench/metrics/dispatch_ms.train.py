"""Host ms per ``train_step`` call in the window, by the host's clock and no synchronise:
the time the host takes to enqueue one step."""

from portbench import readers


def read(run):
    return readers.dispatch_ms(run)
