"""Multitask seg + cls U-Net (port of ``unet_embroidery_seg_tpu/models/unet_multitask.py``).

The ResNet-50 encoder (keys ``encoder.``), unet_resnet50's decoder (its 5
``align_corners=True`` upsamples and 6 fused square convs, through the
hand-written kernels), a 1x1 segmentation head, and a classification head
on the deepest features: ``cls_head = Sequential[GAP, Flatten, Linear(2048,
512), ReLU, Dropout(0.5), Linear(512, num_cls)]``, whose slots give the
reference keys ``cls_head.2.*`` and ``cls_head.5.*``.

``forward`` returns ``(seg_logits (N, num_seg, H, W), cls_logits (N,
num_cls))``, both float32. Dropout is active in train mode; its random
draws cannot match JAX's, so the tests compare with ``cls_head[4].p = 0``.

It takes the mesh's space axis as unet_resnet50 does (bands a multiple of
32 rows high); the class head's pool sums its band over the space group,
so every rank of an image's group computes the image's class logits, and
its dropout, drawn from a seed of the data index, is the same on each.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from unet_embroidery_seg_torch.models.blocks import FinalUpConv, GlobalAvgPool, UnetUpNoBN
from unet_embroidery_seg_torch.models.resnet_backbone import ResNet50Backbone


class MultiTaskUNet(nn.Module):
    takes_space_axis = True

    def __init__(self, num_seg_classes: int = 1, num_cls_classes: int = 3):
        super().__init__()
        self.encoder = ResNet50Backbone()
        self.cls_head = nn.Sequential(
            GlobalAvgPool(), nn.Flatten(), nn.Linear(2048, 512), nn.ReLU(inplace=True),
            nn.Dropout(0.5), nn.Linear(512, num_cls_classes),
        )
        self.up_concat4 = UnetUpNoBN(1024 + 2048, 512)
        self.up_concat3 = UnetUpNoBN(512 + 512, 256)
        self.up_concat2 = UnetUpNoBN(256 + 256, 128)
        self.up_concat1 = UnetUpNoBN(64 + 128, 64)
        self.up_conv = FinalUpConv(64)
        self.seg_head = nn.Conv2d(64, num_seg_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feat1, feat2, feat3, feat4, feat5 = self.encoder(x)
        cls_logits = self.cls_head(feat5)
        up4 = self.up_concat4(feat4, feat5)
        up3 = self.up_concat3(feat3, up4)
        up2 = self.up_concat2(feat2, up3)
        up1 = self.up_concat1(feat1, up2)
        seg_logits = self.seg_head(self.up_conv(up1))
        return seg_logits.float(), cls_logits.float()
