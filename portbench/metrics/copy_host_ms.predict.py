"""Host ms per ``predict_probs`` call inside the program's ``predict.h2d`` (the pageable
upload of the batch) and ``predict.d2h`` (softmax and the probabilities' copy to the host)."""

from portbench import program_spans


def read(run):
    return program_spans.copy_host_ms(run)
