"""Shared building blocks (port of ``unet_embroidery_seg_tpu/models/blocks.py``).

NCHW modules meant to run on ``torch.channels_last`` memory. Parameters stay
float32; a bf16 forward runs under autocast (``engine/steps.py``). Under it
every parameter is read as its bf16 value, as the JAX package's AMP computes
with bf16 copies of its parameters (``ops/flat_adam.py:TreeAdam.cast_params``):
autocast casts the stock convs' weights and biases, the conv3x3 wrappers
round theirs, and ``BatchNorm`` and ``ClassHead`` round theirs here.

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

The mesh's ``space`` axis (each rank holds a band of every image's rows,
``parallel/halo.py``): every module that reads neighbouring rows has a
``space`` attribute, None by default (the whole image, today's code path
exactly), set by ``set_space_axis``. With one, the module first takes the
rows it reads from the ranks above and below, and never reads a zero where
the unsplit model reads a neighbour's row: ``Conv2d`` (every stock conv:
its padding rows inside the image, zero rows at the image's edge, H
padding 0), ``MaxPool2d`` (the stem's ceil-mode pool: the row below, and at
the image's bottom the window clipped as ceil mode clips it; the families'
2x2 pools: no halo, a band of an even number of rows),
``Upsample2x`` (one row each side, the kernels' band mode),
``SquareConv3x3`` and ``Conv3x3Same`` (one row each side, the kernels'
halo-padded mode), ``GlobalAvgPool`` (the band's sums over the space
group). Pointwise modules (BN, ReLU, the 1x1 head, the concat of a skip
and an upsample, which hold the same band) need nothing. A decoder stage
that would resize or pad its upsampled band to its skip's raises
(``AttentionGate`` and the stages' ``_to_size_of``): at the sizes the train
CLI takes (every level's rows split evenly) the two always agree.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu, conv3x3_same
from unet_embroidery_seg_torch.ops.resize import (
    adaptive_avg_pool_1x1,
    center_pad_to,
    resize_bilinear,
)
from unet_embroidery_seg_torch.ops.upsample import upsample2x
from unet_embroidery_seg_torch.parallel.mesh import Group


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that takes its H halo over the space axis when ``space`` is set.

    A kernel of k rows at stride st with padding p reads, for a band of h
    rows (h a multiple of st, starting at a multiple of st), p rows above
    it and k - st - p below: those come from the neighbours, or are zeros
    at the image's edge (the padding the unsplit conv reads there), and the
    conv pads H by 0, so the band's h / st output rows are the unsplit
    conv's. ``space`` None: ``nn.Conv2d`` itself.
    """

    space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return super().forward(x)
        k, st, p = self.kernel_size[0], self.stride[0], self.padding[0]
        x = self.space.exchange(x, p, max(k - st - p, 0), zero_edges=True)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` that takes the rows below its band when ``space`` is set.

    A window of k rows at stride st with no padding reads k - st rows below
    a band (the stem's 3x3 pool: one; the families' 2x2 pools: none). At the
    image's bottom nothing is added: a ceil-mode pool clips its last window
    there, as the unsplit pool does. A band's windows start at its first
    row, so its row count must be a multiple of st, or it raises.
    """

    space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is not None:
            if x.shape[2] % self.stride:
                raise ValueError(f"max pool over the space axis: a band of {x.shape[2]} rows "
                                 f"is not a multiple of the stride {self.stride}; "
                                 "--input-size must be a multiple of the model's deepest "
                                 "stride x --mesh-space")
            x = self.space.exchange(x, 0, self.kernel_size - self.stride)
        return super().forward(x)


def conv3x3(cin: int, cout: int, *, stride: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, *, stride: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, 1, stride=stride, bias=bias)


def _band_pad(space) -> tuple[int, int]:
    """The hand-written conv's H pads for a band with a one-row halo: 1 at the image's edge."""
    return int(space.first), int(space.last)


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

    Under bf16 autocast the scale and bias are used rounded to bf16 values
    (JAX's bf16 parameter copies), in f32 as the normalisation computes; the
    statistics stay f32, and the gradient reaches the f32 parameters through
    the rounding, as JAX's reaches its masters through the cast.

    With a ``process_group`` (``set_batchnorm_group``; data parallelism),
    train mode computes the statistics of the group's global batch as flax
    does (``linen/normalization.py:_compute_stats``, ``use_fast_variance``):
    per-channel sums of x and x^2 in f32, one all-reduce per layer, mean =
    sum / n, var = max(0, sum(x^2) / n - mean^2); normalises in f32 with
    flax's affine (``_normalize``) and its gradient over the whole group
    (``_SyncBatchNorm``), and updates the running statistics in place with
    the biased variance. Eval mode, and no group, stay as above (cuDNN's
    BN, no collective).
    """

    process_group = None

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def _affine(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        weight, bias = self.weight, self.bias
        if (torch.is_autocast_enabled(x.device.type)
                and torch.get_autocast_dtype(x.device.type) == torch.bfloat16):
            weight = weight.to(torch.bfloat16).float()
            bias = bias.to(torch.bfloat16).float()
        return weight, bias

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self._affine(x)
        if self.training:
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, self.running_mean, self.running_var, weight, bias,
                            self.training, self.momentum, self.eps)

    def _sync_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self._affine(x)
        y, mean, var = _SyncBatchNorm.apply(x, weight, bias, self.process_group, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._batch_norm(x)
        if self.process_group is not None:
            return self._sync_batch_norm(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            before = self.running_var.clone()
        y = self._batch_norm(x)
        with torch.no_grad():
            # torch: rv = (1 - m) * before + m * var * n / (n - 1); flax has m * var.
            self.running_var = torch.add(self.running_var * ((n - 1) / n), before,
                                         alpha=(1.0 - self.momentum) / n)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN of NCHW ``x`` over a process group: (y, mean, var); f32 maths.

    Forward: each rank's per-channel sums of x and of x^2 in f32 (f32 x:
    from its Welford mean and variance, one pass, as accurate as the
    single-device BN's statistics; bf16 x: reductions that read it in place
    and accumulate in f32, the second a 2-norm, squared), one all-reduce,
    then flax's mean and fast variance and ``y = x * a + (bias - mean * a)``
    with ``a = weight * rsqrt(var + eps)``, computed in f32 and stored in
    x's dtype and layout in one pass. The per-channel arithmetic is kept to
    few ops: the step is host-bound, and each op is a launch.
    Backward: the gradient of that function over the group's global batch,
    as ``nn.SyncBatchNorm`` computes it: the local sums of dy and of
    dy * (x - mean), one all-reduce, then dx in two passes; the weight's
    and bias's gradients are this rank's share. No pass mixes memory
    layouts (the model runs ``channels_last``). The count n is the local
    count times the group's size: every rank holds as many values, since
    ``Mesh.rows`` and ``Mesh.band`` split evenly or raise, and over the
    space axis every level's rows split evenly (the train CLI's input-size
    rule), so no count needs a collective of its own.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps: float):
        c, dims = x.shape[1], (0, 2, 3)
        m = x.numel() // c
        if x.dtype == torch.float32:
            var, mean = torch.var_mean(x, dims, correction=0)
            sums = torch.cat([mean, torch.addcmul(var, mean, mean)]).mul_(m)
        else:
            sums = torch.cat([x.sum(dims, dtype=torch.float32), torch.linalg.vector_norm(
                x, 2, dims, dtype=torch.float32).square_()])
        dist.all_reduce(sums, group=group)
        n = m * dist.get_world_size(group)
        mean, mean_sq = sums.div_(n).view(2, c).unbind()  # E[x], E[x^2]
        var = torch.addcmul(mean_sq, mean, mean, value=-1.0).clamp_min_(0.0)
        invstd = torch.rsqrt(var + eps)
        a = invstd * weight
        y = torch.empty_like(x)
        torch.addcmul(torch.addcmul(bias, mean, a, value=-1.0)[:, None, None], x,
                      a[:, None, None], out=y)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _mean_grad, _var_grad):
        x, weight, mean, invstd = ctx.saved_tensors
        c, dims, n = x.shape[1], (0, 2, 3), ctx.n
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        dy = dy.contiguous(memory_format=fmt)
        sum_dy = dy.sum(dims, dtype=torch.float32)
        zero = mean.new_zeros(c, 1, 1)  # an f32 operand: the products are taken in f32
        sum_dy_x = torch.addcmul(zero, dy, x).sum(dims)
        # the sums of dy and of dy * (x - mean)
        local = torch.cat([sum_dy, torch.addcmul(sum_dy_x, mean, sum_dy, value=-1.0)])
        grad_bias, grad_weight = local[:c].clone(), local[c:] * invstd
        dist.all_reduce(local, group=ctx.group)
        mean_dy, mean_dy_xmu = local.div_(n).view(2, c).unbind()
        k1 = invstd * weight
        k2 = (k1 * invstd).mul_(invstd).mul_(mean_dy_xmu).neg_()
        k3 = torch.addcmul(k1 * mean_dy, mean, k2).neg_()
        t = torch.empty_like(x, dtype=torch.float32)
        torch.addcmul(k3[:, None, None], x, k2[:, None, None], out=t)
        dx = torch.empty_like(x)
        torch.addcmul(t, dy, k1[:, None, None], out=dx)
        return dx, grad_weight, grad_bias, None, None


def set_batchnorm_group(model: nn.Module, group: Group) -> nn.Module:
    """Set the ``process_group`` that every ``BatchNorm``'s train-mode statistics span."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


class Upsample2x(nn.Module):
    """2x bilinear upsample through the hand-written kernel (``ops/upsample.py``).

    With ``space``: one row from each neighbour, then the kernel's band mode.
    """

    space = None

    def __init__(self, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return upsample2x(x, self.align_corners)
        h = x.shape[2]
        r0 = self.space.index * h
        band = (h * self.space.size, r0, r0 + h)
        return upsample2x(self.space.exchange(x, 1, 1), self.align_corners, band)


class SquareConv3x3(nn.Module):
    """relu(conv3x3(x) + bias) with C_in = C_out, through the hand-written kernel.

    Parameters are ``nn.Conv2d``'s (OIHW ``weight``, ``bias``), so state-dict
    keys and checkpoints are those of the reference's conv. With ``space``:
    one row from each neighbour, then the kernel's halo-padded mode.
    """

    space = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return conv3x3_bias_relu(x, self.weight, self.bias)
        return conv3x3_bias_relu(self.space.exchange(x, 1, 1), self.weight, self.bias,
                                 _band_pad(self.space))


class Conv3x3Same(nn.Module):
    """conv3x3(x) with C_in = C_out and no bias, through the hand-written kernel (epilogue off).

    One OIHW ``weight``, the reference's bias-free ``nn.Conv2d`` parameter.
    With ``space`` as ``SquareConv3x3``.
    """

    space = None

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return conv3x3_same(x, self.weight)
        return conv3x3_same(self.space.exchange(x, 1, 1), self.weight, _band_pad(self.space))


def set_space_axis(model: nn.Module, space) -> nn.Module:
    """Set the ``space`` axis (``parallel/halo.SpaceAxis`` or None) of each row-reading module.

    A model takes one only where every op of it is split right: its class
    says so with ``takes_space_axis`` (every family of the registry); any
    other raises. The model keeps the axis it was given as ``space_axis``,
    so setting it again is one comparison (the steps set theirs on every
    call, predict sets None: one model may serve both).
    """
    if getattr(model, "space_axis", None) is space:
        return model  # already set: the steps call this every step
    if space is not None and not getattr(model, "takes_space_axis", False):
        raise NotImplementedError(f"{type(model).__name__} does not take the space axis "
                                  "(its class sets no takes_space_axis)")
    for m in model.modules():
        if isinstance(m, SPACE_MODULES):
            m.space = space
    model.space_axis = space
    return model


class ClassHead(nn.Conv2d):
    """1x1 class head; ``diff=True`` returns logits[:, 1] - logits[:, 0] as (N, H, W).

    The diff form is one matvec with (w1 - w0, b1 - b0), the binary training
    fast path of the JAX package; the parameters are the same either way.
    Each parameter is cast to the activation type before the subtraction, as
    JAX subtracts its bf16 parameter copies under AMP; in f32 nothing changes.
    """

    def __init__(self, cin: int, num_classes: int, diff: bool = False):
        if diff and num_classes != 2:
            raise ValueError("diff head requires num_classes == 2")
        super().__init__(cin, num_classes, 1, bias=True)
        self.diff = diff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.diff:
            return super().forward(x)
        w, b = self.weight[:, :, 0, 0].to(x.dtype), self.bias.to(x.dtype)
        return torch.einsum("nchw,c->nhw", x, w[1] - w[0]) + (b[1] - b[0])


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
    return nn.Sequential(MaxPool2d(2, 2), block)


class Down(nn.Module):
    """unet_plain's down stage: ``net = down(DoubleConv)`` (keys ``.net.1.``)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.net = down(DoubleConv(in_channels, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


def _to_size_of(x: torch.Tensor, skip: torch.Tensor, resize, space=None) -> torch.Tensor:
    """``x`` resized (or padded) to ``skip``'s H and W; over the space axis never: it raises."""
    hw = tuple(skip.shape[-2:])
    if tuple(x.shape[-2:]) == hw:
        return x
    if space is not None:
        raise ValueError(f"over the space axis a decoder stage's {tuple(x.shape[-2:])} band "
                         f"meets a {hw} skip band: --input-size must be a multiple of the "
                         "model's deepest stride x --mesh-space")
    return resize(x, hw)


class UpPlain(nn.Module):
    """Bilinear 2x (align_corners=False), center pad, concat [skip, x], DoubleConv."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.up = Upsample2x(align_corners=False)
        self.conv = DoubleConv(skip_channels + in_channels, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = _to_size_of(self.up(x), skip, center_pad_to, self.up.space)
        return self.conv(torch.cat([skip, x], dim=1))


class AttentionGate(nn.Module):
    """Additive spatial attention gate (JAX ``blocks.AttentionGate``).

    alpha = sigmoid(BN(psi(relu(BN(theta(skip)) + BN(phi(gate)))))), returns
    skip * alpha. ``theta``, ``phi`` and ``psi`` are ``Sequential[conv1x1,
    BN]``; only ``psi`` has a bias. A gate of another size than the skip is
    resized to it first (with ``space``: raises instead).
    """

    space = None

    def __init__(self, skip_channels: int, gate_channels: int, inter_channels: int):
        super().__init__()
        self.theta = nn.Sequential(conv1x1(skip_channels, inter_channels), BatchNorm(inter_channels))
        self.phi = nn.Sequential(conv1x1(gate_channels, inter_channels), BatchNorm(inter_channels))
        self.psi = nn.Sequential(conv1x1(inter_channels, 1, bias=True), BatchNorm(1))

    def forward(self, skip: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        gate = _to_size_of(gate, skip, resize_bilinear, self.space)
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
        x = _to_size_of(x, skip, resize_bilinear, self.up.space)
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
        x = _to_size_of(self.up(x), skip, resize_bilinear, self.up.space)
        return self.conv(torch.cat([skip, x], dim=1))


class GlobalAvgPool(nn.Module):
    """NCHW -> NC mean over H and W (``ops/resize.adaptive_avg_pool_1x1``).

    With ``space``: the band's f32 sums, summed over the space group
    (``SpaceAxis.sum``, with autograd), over the whole image's H * W; every
    rank of the group then holds the image's mean.
    """

    space = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.space is None:
            return adaptive_avg_pool_1x1(x)
        n_pixels = x.shape[2] * self.space.size * x.shape[3]
        return (self.space.sum(x.float().sum(dim=(2, 3))) / n_pixels).to(x.dtype)


SPACE_MODULES = (Conv2d, MaxPool2d, Upsample2x, SquareConv3x3, Conv3x3Same, AttentionGate,
                 GlobalAvgPool)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference 'normal' init over every module, in module order, from ``generator``.

    ``nn.Linear`` (multitask_unet's class head, which the reference's
    'normal' scheme leaves alone) gets flax ``nn.Dense``'s defaults, as the
    JAX package: a LeCun-normal kernel (truncated at two standard
    deviations) and a zero bias. ``generator`` is a CPU generator, so build
    and initialise on the CPU and move the model afterwards: the weights
    then do not depend on the device.
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
        elif isinstance(m, nn.Linear):
            # flax lecun_normal: variance 1 / fan_in after truncation at +-2 std
            std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.bias.zero_()
    return model
