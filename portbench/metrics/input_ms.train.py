"""Card ms per train step of the work launched outside the step call: plan upload,
gather, on-card augmentation, the loss read (the input layer)."""

from portbench import readers


def read(run):
    return readers.input_ms(run)
