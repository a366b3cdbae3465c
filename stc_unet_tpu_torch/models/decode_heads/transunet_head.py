"""TransUNet head (≙ ``stc_unet_tpu/models/decode_heads/transunet_head.py``).

A ResNet-like conv encoder (stride-2 bottlenecks) → ViT over the /16
feature map → a conv decoder with skip concatenations and bilinear ×2
upsampling (``align_corners=True``), ending in ``conv_out`` (no
``cls_seg``). NCHW in ``channels_last``; the ViT takes the NHWC view.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import resize
from ..bricks import BatchNorm, Conv2d
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .vit import ViT


class EncoderBottleneck(nn.Module):
    """1x1 → 3x3 → 1x1 with a strided 1x1 shortcut. The 3x3 conv has
    stride 2 whatever ``stride`` says, as in JAX (whose ``base_width`` of
    64 keeps the inner width at ``out_channels``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        width = out_channels
        self.downsample_0 = Conv2d(in_channels, out_channels, 1, stride,
                                   bias=False)
        self.downsample_1 = BatchNorm(out_channels)
        self.conv1 = Conv2d(in_channels, width, 1, bias=False)
        self.norm1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, 2, padding=1, bias=False)
        self.norm2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_channels, 1, bias=False)
        self.norm3 = BatchNorm(out_channels)

    def forward(self, x):
        down = self.downsample_1(self.downsample_0(x))
        x = F.relu(self.norm1(self.conv1(x)))
        x = F.relu(self.norm2(self.conv2(x)))
        return F.relu(self.norm3(self.conv3(x)) + down)


class DecoderBottleneck(nn.Module):
    """Bilinear ×2 (``align_corners=True``), the skip concatenated in
    front, then (conv3x3 → BN → relu) × 2."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.layer_0 = Conv2d(in_channels, out_channels, 3, 1, padding=1)
        self.layer_1 = BatchNorm(out_channels)
        self.layer_3 = Conv2d(out_channels, out_channels, 3, 1, padding=1)
        self.layer_4 = BatchNorm(out_channels)

    def forward(self, x, x_concat=None):
        x = resize(x.permute(0, 2, 3, 1), scale_factor=2,
                   mode='bilinear', align_corners=True,
                   warning=False).permute(0, 3, 1, 2)
        if x_concat is not None:
            x = torch.cat([x_concat, x], 1)
        x = F.relu(self.layer_1(self.layer_0(x)))
        return F.relu(self.layer_4(self.layer_3(x)))


class TransUNetModule(BaseDecodeHead):
    """Monolithic TransUNet (config ``my_config/TransUnet.py``: img_dim
    512, out_channels 128, 4 heads, mlp_dim 512, 8 blocks, patch_dim 16,
    2 classes) on the raw image, whose channel count the segmentor gives
    as ``feature_channels``."""

    def __init__(self, img_dim: int = 512, out_ch: int = 128,
                 head_num: int = 4, mlp_dim: int = 512, block_num: int = 8,
                 patch_dim: int = 16, class_num: int = 2,
                 feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        oc = out_ch
        self.conv1 = Conv2d(feature_channels, oc, 7, 2, padding=3,
                            bias=False)
        self.norm1 = BatchNorm(oc)
        self.encoder1 = EncoderBottleneck(oc, oc * 2, stride=2)
        self.encoder2 = EncoderBottleneck(oc * 2, oc * 4, stride=2)
        self.encoder3 = EncoderBottleneck(oc * 4, oc * 8, stride=2)
        self.vit = ViT(img_dim // patch_dim, oc * 8, oc * 8, head_num,
                       mlp_dim, block_num, patch_dim=1)
        self.conv2 = Conv2d(oc * 8, 512, 3, 1, padding=1)
        self.norm2 = BatchNorm(512)
        self.decoder1 = DecoderBottleneck(oc * 4 + 512, oc * 2)
        self.decoder2 = DecoderBottleneck(oc * 4, oc)
        self.decoder3 = DecoderBottleneck(oc * 2, oc // 2)
        self.decoder4 = DecoderBottleneck(oc // 2, oc // 8)
        self.conv_out = Conv2d(oc // 8, class_num, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x1 = F.relu(self.norm1(self.conv1(x)))
        x2 = self.encoder1(x1)
        x3 = self.encoder2(x2)
        x = self.encoder3(x3)
        x = self.vit(x.permute(0, 2, 3, 1), generator)
        b, t, c = x.shape
        side = int(round(t ** 0.5))
        x = x.reshape(b, side, side, c).permute(0, 3, 1, 2)
        x = F.relu(self.norm2(self.conv2(x)))
        x = self.decoder1(x, x3)
        x = self.decoder2(x, x2)
        x = self.decoder3(x, x1)
        x = self.decoder4(x)
        return self.conv_out(x)


def TransUNet(img_dim=512, out_channels=128, head_num=4, mlp_dim=512,
              block_num=8, patch_dim=16, class_num=2, **kwargs):
    """The config's factory: the reference names the encoder width
    ``out_channels``; the head's own ``out_channels`` keeps its default."""
    return TransUNetModule(img_dim=img_dim, out_ch=out_channels,
                           head_num=head_num, mlp_dim=mlp_dim,
                           block_num=block_num, patch_dim=patch_dim,
                           class_num=class_num, **kwargs)


HEADS.register_module(name='TransUNet', module=TransUNet)
