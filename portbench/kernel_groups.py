"""Kernel-name groups: a frozen copy of ``unet_embroidery_seg_torch/utils/timing.KERNEL_GROUPS``.

First match wins; a name that matches none is "other elementwise". The
groups whose name starts with ``port`` are the program's hand-written
kernels; every other group is a library's (cuDNN, cuBLAS, PyTorch's own).
"""

from __future__ import annotations

KERNEL_GROUPS = [
    ("port upsample2x backward", ("upsample2x_bwd_kernel",)),
    ("port upsample2x", ("upsample2x_kernel",)),
    ("port conv3x3 f32 tf32x3 weight pack", ("conv3x3_pack_tf32x3",)),
    ("port conv3x3 f32 tf32x3 (forward and dgrad)", ("conv3x3_wgmma_kernel<float",)),
    ("port conv3x3 (forward and dgrad)", ("conv3x3_wgmma_kernel", "conv3x3_c64_kernel",
                                          "conv3x3_fma_kernel")),
    ("memcpy", ("Memcpy", "memcpy")),
    ("collectives (NCCL)", ("nccl", "Nccl")),
    ("Adam (foreach)", ("multi_tensor", "foreach", "Adam", "adam")),
    ("sort (Lovasz)", ("sort", "Sort", "radix", "Radix")),
    ("cuDNN/cuBLAS conv and GEMM", ("conv", "gemm", "xmma", "sm90", "cutlass", "implicit",
                                    "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")),
    ("cat", ("CatArrayBatchedCopy", "cat")),
    ("softmax", ("softmax",)),
    ("reductions and scans", ("reduce", "scan", "Scan")),
    ("pool", ("pool",)),
]

# The square conv's main kernels (forward and dgrad, one launch a call) and its weight pack.
CONV3X3_MAIN = ("conv3x3_wgmma_kernel", "conv3x3_c64_kernel", "conv3x3_fma_kernel")
CONV3X3_PACK = ("conv3x3_pack_tf32x3",)
UPSAMPLE_FWD = ("upsample2x_kernel",)
UPSAMPLE_BWD = ("upsample2x_bwd_kernel",)


def group_of(name: str) -> str:
    for group, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise"


def is_port(name: str) -> bool:
    return group_of(name).startswith("port ")


def matches(name: str, keys: tuple[str, ...]) -> bool:
    return any(k in name for k in keys)
