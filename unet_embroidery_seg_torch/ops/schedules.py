"""Learning-rate schedules and the optimizer (port of ``ops/schedules.py``).

The schedule functions are the port's own copies of the JAX module's pure
functions (that module imports optax). The schedule is epoch-indexed: the
engine sets the learning rate once per epoch (``set_learning_rate``).

The optimizer is ``torch.optim.Adam`` over the float32 parameters with the
semantics of the JAX package's ``TreeAdam`` (``ops/flat_adam.py``): coupled
L2 weight decay added to the gradient before the moments, betas (momentum,
0.999), eps 1e-8, bias correction from step 1. The float32 parameters are
the masters; bf16 autocast casts them per op, which stands in for TreeAdam's
bf16 parameter store. JAX's other variants have no option here: its optax
chain (``make_optimizer``) is this update to f32 rounding, and its
``FlatAdam`` (one arena per state), measured on an H100, did not shorten
the train step beyond the host's spread; ``tests/torch_alternates.py``
holds both to this optimizer.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Iterable

import torch


def yolox_warm_cos_lr(
    lr: float,
    min_lr: float,
    total_iters: int,
    warmup_total_iters: float,
    warmup_lr_start: float,
    no_aug_iter: float,
    iters: float,
) -> float:
    """Quadratic warmup -> cosine decay -> min-LR floor (epoch-indexed)."""
    if iters <= warmup_total_iters:
        return (lr - warmup_lr_start) * pow(iters / float(warmup_total_iters), 2) + warmup_lr_start
    if iters >= total_iters - no_aug_iter:
        return min_lr
    return min_lr + 0.5 * (lr - min_lr) * (
        1.0
        + math.cos(
            math.pi * (iters - warmup_total_iters) / (total_iters - warmup_total_iters - no_aug_iter)
        )
    )


def step_lr(lr: float, decay_rate: float, step_size: float, iters: float) -> float:
    """Geometric step decay."""
    if step_size < 1:
        raise ValueError("step_size must above 1.")
    n = iters // step_size
    return lr * decay_rate**n


def get_lr_scheduler(
    lr_decay_type: str,
    lr: float,
    min_lr: float,
    total_iters: int,
    warmup_iters_ratio: float = 0.05,
    warmup_lr_ratio: float = 0.1,
    no_aug_iter_ratio: float = 0.05,
    step_num: int = 10,
) -> Callable[[float], float]:
    """The epoch -> lr function with the reference's clamping rules."""
    if lr_decay_type == "cos":
        warmup_total_iters = min(max(warmup_iters_ratio * total_iters, 1), 3)
        warmup_lr_start = max(warmup_lr_ratio * lr, 1e-6)
        no_aug_iter = min(max(no_aug_iter_ratio * total_iters, 1), 15)
        return partial(yolox_warm_cos_lr, lr, min_lr, total_iters, warmup_total_iters,
                       warmup_lr_start, no_aug_iter)
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_iters / step_num
    return partial(step_lr, lr, decay_rate, step_size)


def resolve_init_lrs(batch_size: int, init_lr: float = 1e-4) -> tuple[float, float]:
    """Batch-size-scaled init/min LR with the reference's clamps (nbs 16, limits 1e-4)."""
    min_lr = init_lr * 0.01
    nbs = 16
    lr_limit_max = 1e-4
    lr_limit_min = 1e-4
    init_lr_fit = min(max(batch_size / nbs * init_lr, lr_limit_min), lr_limit_max)
    min_lr_fit = min(max(batch_size / nbs * min_lr, lr_limit_min * 1e-2), lr_limit_max * 1e-2)
    return init_lr_fit, min_lr_fit


def make_train_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
) -> torch.optim.Adam:
    """Adam with TreeAdam's semantics over float32 parameters, as a foreach update.

    The foreach update writes the parameters with in-place ops that bump
    their version counters, so the conv kernel's packed-weight cache
    (grad-off calls, e.g. eval between epochs) sees every step. The fused
    update (``fused=True``) does not bump them and is not used.
    """
    return torch.optim.Adam(params, lr=learning_rate, betas=(momentum, 0.999), eps=1e-8,
                            weight_decay=weight_decay, foreach=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (once per epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
