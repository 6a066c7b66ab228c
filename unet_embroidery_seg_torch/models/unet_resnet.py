"""ResNet50-encoder U-Net (port of ``unet_embroidery_seg_tpu/models/unet_resnet.py``).

Decoder: 4 UnetUpNoBN stages over in_filters [192, 512, 1024, 3072] ->
out_filters [64, 128, 256, 512], a final 2x upsample head back to full
resolution, and a 1x1 class head. ``decoder_width`` scales the decoder
widths (1.0 is the reference architecture); checkpoints are width-specific.
``diff_head=True`` (binary training) returns the (N, H, W) logit difference
instead of (N, 2, H, W) logits, with the same parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import ClassHead, FinalUpConv, UnetUpNoBN
from unet_embroidery_seg_torch.models.resnet_backbone import ResNet50Backbone


class UNetResNet50(nn.Module):
    def __init__(self, num_classes: int = 21, decoder_width: float = 1.0, diff_head: bool = False):
        super().__init__()
        self.resnet = ResNet50Backbone()
        out = tuple(int(f * decoder_width) for f in (64, 128, 256, 512))
        # in_channels = skip (feat1..feat4: 64, 256, 512, 1024) + the upsampled input
        self.up_concat4 = UnetUpNoBN(1024 + 2048, out[3])
        self.up_concat3 = UnetUpNoBN(512 + out[3], out[2])
        self.up_concat2 = UnetUpNoBN(256 + out[2], out[1])
        self.up_concat1 = UnetUpNoBN(64 + out[1], out[0])
        self.up_conv = FinalUpConv(out[0])
        self.final = ClassHead(out[0], num_classes, diff=diff_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat1, feat2, feat3, feat4, feat5 = self.resnet(x)
        up4 = self.up_concat4(feat4, feat5)
        up3 = self.up_concat3(feat3, up4)
        up2 = self.up_concat2(feat2, up3)
        up1 = self.up_concat1(feat1, up2)
        return self.final(self.up_conv(up1)).float()
