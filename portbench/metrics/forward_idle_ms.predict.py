"""Card-idle ms per ``predict_probs`` call inside the program's ``predict.forward`` spans (their
operators' spans included): the inference forward's dispatch."""

from portbench import program_spans


def read(run):
    return program_spans.phase_idle_ms(run, "predict.forward")
