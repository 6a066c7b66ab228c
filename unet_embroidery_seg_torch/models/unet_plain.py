"""Plain U-Net (port of ``unet_embroidery_seg_tpu/models/unet_plain.py``).

Five encoder levels of DoubleConv (64 -> 1024 channels at
``base_channels=64``), MaxPool downs, a decoder of 2x upsample
(align_corners=False), center pad and skip concat, and a 1x1 class head.
``diff_head=True`` (binary training) returns the (N, H, W) logit difference
instead of (N, 2, H, W) logits, with the same parameters.

It takes the mesh's space axis (``blocks.set_space_axis``): a band of rows
whose height is a multiple of 16, the deepest stride, computes the
unsplit model's rows (no center pad: every skip band has its upsample's
height).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import ClassHead, DoubleConv, Down, UpPlain


class UNetPlain(nn.Module):
    takes_space_axis = True

    def __init__(self, num_classes: int = 2, base_channels: int = 64, diff_head: bool = False):
        super().__init__()
        self.base_channels = c = base_channels
        self.inc = DoubleConv(3, c)
        self.down1 = Down(c, c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.down3 = Down(c * 4, c * 8)
        self.down4 = Down(c * 8, c * 16)
        self.up1 = UpPlain(c * 16, c * 8, c * 8)
        self.up2 = UpPlain(c * 8, c * 4, c * 4)
        self.up3 = UpPlain(c * 4, c * 2, c * 2)
        self.up4 = UpPlain(c * 2, c, c)
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
