"""Card operations (kernels, copies, memsets) launched inside the program's ``step.train``
spans, per train step, matched to their launch calls by correlation: what a captured step or
fused kernels would cut."""

from portbench import program_spans


def read(run):
    return program_spans.step_launches(run)
