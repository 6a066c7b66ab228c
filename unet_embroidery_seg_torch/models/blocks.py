"""Shared building blocks (port of ``unet_embroidery_seg_tpu/models/blocks.py``).

NCHW modules meant to run on ``torch.channels_last`` memory. Parameters stay
float32; a bf16 forward runs under autocast (``engine/steps.py``).

Initialisation mirrors the reference's ``weights_init`` 'normal' scheme, as
the JAX package does: conv kernels N(0, 0.02), BN scale N(1, 0.02), biases 0,
here drawn from an explicit ``torch.Generator`` (``init_weights``).

The two hand-written kernels sit behind ``Upsample2x`` (every 2x upsample)
and ``SquareConv3x3`` (every C -> C 3x3 conv that is followed by bias and
ReLU); every other conv is a stock ``nn.Conv2d``, as the JAX package left
those to XLA.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
from unet_embroidery_seg_torch.ops.upsample import upsample2x


def conv3x3(cin: int, cout: int, *, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, *, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm as the JAX package's flax ``nn.BatchNorm`` (momentum 0.1, eps 1e-5).

    Normalisation uses the biased batch variance, as in torch. The running
    variance is updated as flax does it, with the biased variance too:
    ``ra_var = 0.9 * ra_var + 0.1 * var``, where ``nn.BatchNorm2d`` puts in
    the unbiased one, n / (n - 1) times larger for n values per channel.
    Train mode lets torch update the buffers and then scales its update
    back (a few ops on C values), so the forward itself stays cuDNN's. The
    corrected variance is a new tensor bound to the buffer: autograd saved
    the one torch updated and checks that it is not modified in place.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            before = self.running_var.clone()
        y = super().forward(x)
        with torch.no_grad():
            # torch: rv = (1 - m) * before + m * var * n / (n - 1); flax has m * var.
            self.running_var = torch.add(self.running_var * ((n - 1) / n), before,
                                         alpha=(1.0 - self.momentum) / n)
        return y


class Upsample2x(nn.Module):
    """2x bilinear upsample through the hand-written kernel (``ops/upsample.py``)."""

    def __init__(self, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x(x, self.align_corners)


class SquareConv3x3(nn.Module):
    """relu(conv3x3(x) + bias) with C_in = C_out, through the hand-written kernel.

    Parameters are ``nn.Conv2d``'s (OIHW ``weight``, ``bias``), so state-dict
    keys and checkpoints are those of the reference's conv.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_bias_relu(x, self.weight, self.bias)


class ClassHead(nn.Conv2d):
    """1x1 class head; ``diff=True`` returns logits[:, 1] - logits[:, 0] as (N, H, W).

    The diff form is one matvec with (w1 - w0, b1 - b0), the binary training
    fast path of the JAX package; the parameters are the same either way.
    """

    def __init__(self, cin: int, num_classes: int, diff: bool = False):
        if diff and num_classes != 2:
            raise ValueError("diff head requires num_classes == 2")
        super().__init__(cin, num_classes, 1, bias=True)
        self.diff = diff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.diff:
            return super().forward(x)
        wd = (self.weight[1, :, 0, 0] - self.weight[0, :, 0, 0]).to(x.dtype)
        bd = (self.bias[1] - self.bias[0]).to(x.dtype)
        return torch.einsum("nchw,c->nhw", x, wd) + bd


class UnetUpNoBN(nn.Module):
    """ResNet-U-Net decoder stage: up(x), concat [skip, up(x)], two biased conv3x3 + ReLU.

    No BN, as in the reference decoder. ``conv1`` changes the width and is a
    stock conv; ``conv2`` is square and runs through the conv3x3 kernel.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = Upsample2x(align_corners=True)
        self.conv1 = conv3x3(in_channels, out_channels, bias=True)
        self.conv2 = SquareConv3x3(out_channels)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([skip, self.up(x)], dim=1)
        return self.conv2(F.relu(self.conv1(x)))


class FinalUpConv(nn.Sequential):
    """Extra 2x upsample head: Sequential[up, conv, relu, conv, relu].

    The slots keep the reference's indices, so the keys are ``up_conv.1.*``
    and ``up_conv.3.*``. Both convs are square and fuse their ReLU, so the
    ReLU slots hold ``nn.Identity``.
    """

    def __init__(self, channels: int):
        super().__init__(
            Upsample2x(align_corners=True),
            SquareConv3x3(channels),
            nn.Identity(),
            SquareConv3x3(channels),
            nn.Identity(),
        )


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference 'normal' init over every module, in module order, from ``generator``.

    ``generator`` is a CPU generator, so build and initialise on the CPU and
    move the model afterwards: the weights then do not depend on the device.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, SquareConv3x3)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
            m.reset_running_stats()
    return model
