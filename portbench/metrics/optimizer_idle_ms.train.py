"""Card-idle ms per train step inside the program's ``step.optimizer`` spans (their operators'
spans included): ``optimizer.step()`` (Adam, ``foreach``)."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "step.optimizer")
