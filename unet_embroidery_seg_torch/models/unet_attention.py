"""Attention U-Net (port of ``unet_embroidery_seg_tpu/models/unet_attention.py``).

The UNetPlain topology with additive attention gates scaling the skip
paths; a decoder stage of another size than its skip resizes (bilinear)
instead of padding. The down stages are ``Sequential[pool, DoubleConv]``
(keys ``down{i}.1.``), as in the reference. It takes the mesh's space
axis as unet_plain does (bands a multiple of 16 rows high, no resize).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import ClassHead, DoubleConv, UpAttn, down


class AttentionUNet(nn.Module):
    takes_space_axis = True

    def __init__(self, num_classes: int = 2, base_channels: int = 64, diff_head: bool = False):
        super().__init__()
        self.base_channels = c = base_channels
        self.inc = DoubleConv(3, c)
        self.down1 = down(DoubleConv(c, c * 2))
        self.down2 = down(DoubleConv(c * 2, c * 4))
        self.down3 = down(DoubleConv(c * 4, c * 8))
        self.down4 = down(DoubleConv(c * 8, c * 16))
        self.up1 = UpAttn(c * 16, c * 8, c * 8)
        self.up2 = UpAttn(c * 8, c * 4, c * 4)
        self.up3 = UpAttn(c * 4, c * 2, c * 2)
        self.up4 = UpAttn(c * 2, c, c)
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
