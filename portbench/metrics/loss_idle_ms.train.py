"""Card-idle ms per train step inside the program's ``step.loss`` spans (their operators' spans
included): the loss (the Lovasz hinge's sort and scan, or BCE)."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "step.loss")
