"""Card-idle ms per train step inside the program's ``step.forward`` spans (their operators'
spans included): its inputs' upload and the forward (module dispatch, autocast)."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "step.forward")
