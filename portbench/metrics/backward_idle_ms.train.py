"""Card-idle ms per train step inside the program's ``step.backward`` spans (their operators'
spans included): autograd's backward (and ``zero_grad``, which opens it)."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "step.backward")
