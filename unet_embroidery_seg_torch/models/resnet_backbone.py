"""ResNet-50 multi-feature backbone (port of ``unet_embroidery_seg_tpu/models/resnet_backbone.py``).

Returns 5 feature maps [feat1..feat5] with channels [64, 256, 512, 1024,
2048] at strides [2, 4, 8, 16, 32], with the reference's two quirks:

  - the stem maxpool is 3x3 stride 2 with padding 0 and ceil_mode=True;
  - feat1 is taken before that maxpool (after conv7x7 + BN + ReLU).

Only the direct 7x7 stem is ported (the JAX default, ``stem_mode="direct"``).
Over the mesh's space axis (``blocks.set_space_axis``) the stem conv takes
3 rows above its band and 2 below, the pool 1 below, each stride-2 3x3 1
above; the stride-2 1x1 downsample needs none (a band starts on an even
row at every level).
Module names give the reference keys: ``resnet.layer1.0.conv1.weight``,
``resnet.layer1.0.downsample.0.weight``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_embroidery_seg_torch.models.blocks import BatchNorm, Conv2d, MaxPool2d, conv1x1, conv3x3


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride) -> 1x1 expand(x4), residual add, ReLU."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv1x1(inplanes, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride=stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv1x1(planes, planes * self.expansion)
        self.bn3 = BatchNorm(planes * self.expansion)
        self.downsample = (
            nn.Sequential(
                conv1x1(inplanes, planes * self.expansion, stride=stride),
                BatchNorm(planes * self.expansion),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet50Backbone(nn.Module):
    """Stem + 4 stages of (3, 4, 6, 3) bottlenecks, multi-feature forward."""

    def __init__(self, layers: tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = MaxPool2d(3, stride=2, padding=0, ceil_mode=True)  # no parameters
        inplanes = 64
        for stage, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
            stride = 1 if stage == 1 else 2
            stage_blocks = []
            for b in range(blocks):
                use_ds = b == 0 and (stride != 1 or inplanes != planes * Bottleneck.expansion)
                stage_blocks.append(
                    Bottleneck(inplanes, planes, stride if b == 0 else 1, use_ds)
                )
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*stage_blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feat1 = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(feat1)
        feats = [feat1]
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            feats.append(x)
        return feats
