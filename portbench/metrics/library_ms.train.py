"""Card ms per train step of the kernels launched inside the step call that are not the
program's own (cuDNN, cuBLAS, BN, elementwise, the sort, Adam; ``kernel_groups``)."""

from portbench import readers


def read(run):
    return readers.library_ms(run)
