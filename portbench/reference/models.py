"""Plain PyTorch versions of the benchmark's two models, with the program's state-dict keys.

Every conv is ``F.conv2d`` and every 2x upsample ``F.interpolate``; nothing
here imports the program. The architectures are the reference
repository's (``model/model_factory.py``): a ResNet-50 encoder (the stem's
max pool 3x3, stride 2, padding 0, ceil mode; feat1 taken before it) under
a decoder of four ``UnetUpNoBN`` stages and a final 2x upsample head, and
the plain U-Net of five ``DoubleConv`` levels. A binary model trains
through the logit difference of its two-class head (``diff=True``).

Precision (``set_precision``): ``f32`` computes in float32 and is run
with TF32 off; ``tf32`` is float32 with cuDNN's convolutions in TF32 (the
program's own float32 setting); ``bf16`` runs under bf16 autocast; ``fp8``
runs under bf16 autocast with each conv's input and weight rounded to
float8 e4m3 first, each scaled by its own largest magnitude, as an fp8 GEMM
reads them. ``bf16`` and ``fp8`` are the
controls, the reference one step below the precision a configuration
states; ``tf32`` and ``bf16`` are also the witnesses, the reference at a
configuration's own precision, which show what rounding alone gives.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, returned in bf16."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn)
    return (q.float() / scale).to(torch.bfloat16)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose operands are rounded to fp8 under the ``fp8`` precision."""

    precision = "f32"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision != "fp8":
            return super().forward(x)
        b = None if self.bias is None else self.bias.to(torch.bfloat16)
        return F.conv2d(fp8_round(x), fp8_round(self.weight), b, self.stride, self.padding)


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> Conv:
    return Conv(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Up(nn.Module):
    def __init__(self, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=self.align_corners)


class Head(Conv):
    """1x1 two-class head; ``diff``: the logit difference (N, H, W)."""

    def __init__(self, cin: int, classes: int, diff: bool):
        super().__init__(cin, classes, 1, bias=True)
        self.diff = diff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y[:, 1] - y[:, 0] if self.diff else y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = conv(cin, planes, 1), nn.BatchNorm2d(planes)
        self.conv2, self.bn2 = conv(planes, planes, 3, stride), nn.BatchNorm2d(planes)
        self.conv3, self.bn3 = conv(planes, planes * 4, 1), nn.BatchNorm2d(planes * 4)
        self.bn3.residual_end = True  # the residual branch's last layer (``gen.init_spec``)
        self.downsample = (nn.Sequential(conv(cin, planes * 4, 1, stride), nn.BatchNorm2d(planes * 4))
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + identity)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2), nn.BatchNorm2d(64)
        cin = 64
        for stage, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), 1):
            stride = 1 if stage == 1 else 2
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1, b == 0))
                cin = planes * 4
            self.add_module(f"layer{stage}", nn.Sequential(*layer))

    def forward(self, x):
        feat1 = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(feat1, 3, 2, 0, ceil_mode=True)
        feats = [feat1]
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            feats.append(x)
        return feats


class UpNoBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = Up(True)
        self.conv1 = conv(cin, cout, 3, bias=True)
        self.conv2 = conv(cout, cout, 3, bias=True)

    def forward(self, skip, x):
        x = torch.cat([skip, self.up(x)], dim=1)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class UNetResNet50(nn.Module):
    def __init__(self, classes: int = 2, diff: bool = False):
        super().__init__()
        self.resnet = ResNet50()
        self.up_concat4 = UpNoBN(1024 + 2048, 512)
        self.up_concat3 = UpNoBN(512 + 512, 256)
        self.up_concat2 = UpNoBN(256 + 256, 128)
        self.up_concat1 = UpNoBN(64 + 128, 64)
        self.up_conv = nn.Sequential(Up(True), conv(64, 64, 3, bias=True), nn.ReLU(),
                                     conv(64, 64, 3, bias=True), nn.ReLU())
        self.final = Head(64, classes, diff)

    def forward(self, x):
        f1, f2, f3, f4, f5 = self.resnet(x)
        x = self.up_concat4(f4, f5)
        x = self.up_concat3(f3, x)
        x = self.up_concat2(f2, x)
        x = self.up_concat1(f1, x)
        return self.final(self.up_conv(x)).float()


def double_conv(cin: int, c: int) -> nn.Sequential:
    return nn.Sequential(conv(cin, c, 3), nn.BatchNorm2d(c), nn.ReLU(),
                         conv(c, c, 3), nn.BatchNorm2d(c), nn.ReLU())


class DoubleConv(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.net = double_conv(cin, c)

    def forward(self, x):
        return self.net(x)


class Down(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.net = nn.Sequential(nn.MaxPool2d(2, 2), DoubleConv(cin, c))

    def forward(self, x):
        return self.net(x)


class UpPlain(nn.Module):
    def __init__(self, cin: int, skip: int, c: int):
        super().__init__()
        self.up = Up(False)
        self.conv = DoubleConv(skip + cin, c)

    def forward(self, x, skip):
        x = self.up(x)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        if dh or dw:  # centre pad to the skip's size
            x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([skip, x], dim=1))


class UNetPlain(nn.Module):
    def __init__(self, classes: int = 2, diff: bool = False, c: int = 64):
        super().__init__()
        self.inc = DoubleConv(3, c)
        self.down1, self.down2 = Down(c, 2 * c), Down(2 * c, 4 * c)
        self.down3, self.down4 = Down(4 * c, 8 * c), Down(8 * c, 16 * c)
        self.up1, self.up2 = UpPlain(16 * c, 8 * c, 8 * c), UpPlain(8 * c, 4 * c, 4 * c)
        self.up3, self.up4 = UpPlain(4 * c, 2 * c, 2 * c), UpPlain(2 * c, c, c)
        self.outc = Head(c, classes, diff)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up4(self.up3(self.up2(self.up1(x5, x4), x3), x2), x1)
        return self.outc(x).float()


MODELS = {"unet_resnet50": UNetResNet50, "unet_plain": UNetPlain}


def build(config: dict, diff: bool) -> nn.Module:
    """The configuration's model, float32, on the CPU (parameters uninitialised: load weights)."""
    return MODELS[config["model"]](config["num_classes"], diff)


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    for m in model.modules():
        if isinstance(m, Conv):
            m.precision = precision
    model.precision = precision
    return model


class Precision:
    """The numeric context of a reference call: float32 with TF32 off (``f32``) or on for
    cuDNN's convolutions only (``tf32``); bf16 autocast otherwise."""

    def __init__(self, precision: str, device: torch.device):
        self.precision, self.device = precision, torch.device(device)

    def __enter__(self):
        self._flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = self.precision == "tf32"
        self._cast = torch.autocast(self.device.type, dtype=torch.bfloat16,
                                    enabled=self.precision not in ("f32", "tf32"))
        self._cast.__enter__()
        return self

    def __exit__(self, *exc):
        self._cast.__exit__(*exc)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._flags
        return False
