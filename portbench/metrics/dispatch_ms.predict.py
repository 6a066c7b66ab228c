"""Host ms per ``predict_fn`` call in the window (inputs' copy to the card included),
by the host's clock and no synchronise."""

from portbench import readers


def read(run):
    return readers.dispatch_ms(run)
