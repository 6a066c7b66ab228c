"""Dense-block U-Net (port of ``unet_embroidery_seg_tpu/models/unet_dualdense.py``).

Every stage is a DenseNet-style block (``growth_rate`` 32, ``num_layers``
3, concat-everything) followed by a 1x1 transition, in the same 5-down /
4-up topology as UNetPlain. Its 3x3 convs change the width (to
``growth_rate``), so none runs through the square conv kernel; its 2x
upsamples (align_corners=False) run through the upsample kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import ClassHead, DenseConvBlock, UpDense, down


class DualDenseUNet(nn.Module):
    def __init__(self, num_classes: int = 2, base_channels: int = 64, growth_rate: int = 32,
                 num_layers: int = 3, diff_head: bool = False):
        super().__init__()
        self.base_channels = c = base_channels
        self.growth_rate = g = growth_rate
        self.num_layers = nl = num_layers
        self.inc = DenseConvBlock(3, c, g, nl)
        self.down1 = down(DenseConvBlock(c, c * 2, g, nl))
        self.down2 = down(DenseConvBlock(c * 2, c * 4, g, nl))
        self.down3 = down(DenseConvBlock(c * 4, c * 8, g, nl))
        self.down4 = down(DenseConvBlock(c * 8, c * 16, g, nl))
        self.up1 = UpDense(c * 16, c * 8, c * 8, g, nl)
        self.up2 = UpDense(c * 8, c * 4, c * 4, g, nl)
        self.up3 = UpDense(c * 4, c * 2, c * 2, g, nl)
        self.up4 = UpDense(c * 2, c, c, g, nl)
        self.outc = ClassHead(c, num_classes, diff=diff_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x).float()
