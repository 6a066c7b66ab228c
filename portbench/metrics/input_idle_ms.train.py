"""Card-idle ms per train step inside the program's ``input.batch`` spans: the chunk's gather,
augmentation and seeding of the step's batch."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "input.batch")
