"""Shared building blocks (port of ``unet_embroidery_seg_tpu/models/blocks.py``).

NCHW modules meant to run on ``torch.channels_last`` memory. Parameters stay
float32; a bf16 forward runs under autocast (``engine/steps.py``).

Initialisation mirrors the reference's ``weights_init`` 'normal' scheme, as
the JAX package does: conv kernels N(0, 0.02), BN scale N(1, 0.02), biases 0,
here drawn from an explicit ``torch.Generator`` (``init_weights``).

The two hand-written kernels sit behind ``Upsample2x`` (every 2x upsample,
in the family's convention), ``SquareConv3x3`` (every C -> C 3x3 conv that is
followed by bias and ReLU: unet_resnet50's decoder) and ``Conv3x3Same``
(every bias-free C -> C 3x3 conv: the ``conv2`` of each ``DoubleConv``);
every other conv is a stock ``nn.Conv2d``, as the JAX package left those to
XLA. Module and slot names follow the reference's state-dict keys (the
JAX package's ``utils/torch_interop.py`` maps them; ``utils/interop.py`` is
the port's copy).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_same
from unet_embroidery_seg_torch.ops.resize import center_pad_to, resize_bilinear
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


class Conv3x3Same(nn.Module):
    """conv3x3(x) with C_in = C_out and no bias, through the hand-written kernel (epilogue off).

    One OIHW ``weight``, the reference's bias-free ``nn.Conv2d`` parameter.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_same(x, self.weight)


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


class DoubleConv(nn.Module):
    """2 x [conv3x3 (bias-free) -> BN -> ReLU] (JAX ``blocks.DoubleConv``).

    ``net = Sequential[conv, BN, ReLU, conv, BN, ReLU]``, parameters at slots
    0/1/3/4 as in the reference. ``conv1`` changes the width and is a stock
    conv; ``conv2`` is square and runs through the conv3x3 kernel.
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.net = nn.Sequential(
            conv3x3(in_channels, features), BatchNorm(features), nn.ReLU(inplace=True),
            Conv3x3Same(features), BatchNorm(features), nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def down(block: nn.Module) -> nn.Sequential:
    """MaxPool(2, 2) -> ``block`` as ``Sequential[pool, block]`` (JAX ``blocks.Down``; keys ``.1.``)."""
    return nn.Sequential(nn.MaxPool2d(2, 2), block)


class Down(nn.Module):
    """unet_plain's down stage: ``net = down(DoubleConv)`` (keys ``.net.1.``)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.net = down(DoubleConv(in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def _to_size_of(x: torch.Tensor, skip: torch.Tensor, resize) -> torch.Tensor:
    hw = tuple(skip.shape[-2:])
    return x if tuple(x.shape[-2:]) == hw else resize(x, hw)


class UpPlain(nn.Module):
    """Bilinear 2x (align_corners=False), center pad, concat [skip, x], DoubleConv."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.up = Upsample2x(align_corners=False)
        self.conv = DoubleConv(skip_channels + in_channels, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = _to_size_of(self.up(x), skip, center_pad_to)
        return self.conv(torch.cat([skip, x], dim=1))


class AttentionGate(nn.Module):
    """Additive spatial attention gate (JAX ``blocks.AttentionGate``).

    alpha = sigmoid(BN(psi(relu(BN(theta(skip)) + BN(phi(gate)))))), returns
    skip * alpha. ``theta``, ``phi`` and ``psi`` are ``Sequential[conv1x1,
    BN]``; only ``psi`` has a bias. A gate of another size than the skip is
    resized to it first.
    """

    def __init__(self, skip_channels: int, gate_channels: int, inter_channels: int):
        super().__init__()
        self.theta = nn.Sequential(conv1x1(skip_channels, inter_channels), BatchNorm(inter_channels))
        self.phi = nn.Sequential(conv1x1(gate_channels, inter_channels), BatchNorm(inter_channels))
        self.psi = nn.Sequential(conv1x1(inter_channels, 1, bias=True), BatchNorm(1))

    def forward(self, skip: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        gate = _to_size_of(gate, skip, resize_bilinear)
        f = F.relu(self.theta(skip) + self.phi(gate))
        return skip * torch.sigmoid(self.psi(f))


class UpAttn(nn.Module):
    """Attention-gated decoder stage: up(x) gates the skip, then concat [skip, x], DoubleConv.

    ``up(x)`` feeds both the gate's ``phi`` and the concat, so its gradient
    is the sum of the two.
    """

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.up = Upsample2x(align_corners=False)
        self.attn = AttentionGate(skip_channels, in_channels, max(features // 2, 16))
        self.conv = DoubleConv(skip_channels + in_channels, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        skip = self.attn(skip, x)
        x = _to_size_of(x, skip, resize_bilinear)
        return self.conv(torch.cat([skip, x], dim=1))


class DenseLayer(nn.Module):
    """One dense layer: ``net = Sequential[BN, ReLU, conv3x3(growth, bias-free)]``."""

    def __init__(self, in_channels: int, growth_rate: int):
        super().__init__()
        self.net = nn.Sequential(BatchNorm(in_channels), nn.ReLU(inplace=True),
                                 conv3x3(in_channels, growth_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class DenseBlock(nn.Module):
    """DenseNet-style block: each layer reads the concat of all earlier features.

    Returns the concat of the input and every layer's output (in_channels +
    num_layers * growth_rate channels). Its convs change the width, so they
    are stock convs.
    """

    def __init__(self, in_channels: int, growth_rate: int = 32, num_layers: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            DenseLayer(in_channels + i * growth_rate, growth_rate) for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = [x]
        for layer in self.layers:
            features.append(layer(torch.cat(features, dim=1) if len(features) > 1 else x))
        return torch.cat(features, dim=1)


class DenseConvBlock(nn.Module):
    """DenseBlock, then the 1x1 transition ``trans = Sequential[conv1x1, BN]``, then ReLU."""

    def __init__(self, in_channels: int, features: int, growth_rate: int = 32,
                 num_layers: int = 3):
        super().__init__()
        self.dense = DenseBlock(in_channels, growth_rate, num_layers)
        self.trans = nn.Sequential(conv1x1(in_channels + num_layers * growth_rate, features),
                                   BatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.trans(self.dense(x)))


class UpDense(nn.Module):
    """Dense decoder stage: up(x), resized to the skip where sizes differ, concat, DenseConvBlock."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 growth_rate: int = 32, num_layers: int = 3):
        super().__init__()
        self.up = Upsample2x(align_corners=False)
        self.conv = DenseConvBlock(skip_channels + in_channels, features, growth_rate, num_layers)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = _to_size_of(self.up(x), skip, resize_bilinear)
        return self.conv(torch.cat([skip, x], dim=1))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference 'normal' init over every module, in module order, from ``generator``.

    ``generator`` is a CPU generator, so build and initialise on the CPU and
    move the model afterwards: the weights then do not depend on the device.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, SquareConv3x3, Conv3x3Same)):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
            m.reset_running_stats()
    return model
