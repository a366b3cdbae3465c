"""EncoderDecoderFull: the segmentor of the monolithic nets
(≙ ``stc_unet_tpu/models/segmentors/encoder_decoder_full.py``).

The decode head takes the raw image (DC-UNet, UNet++, TransUNet,
SwinUNet). As in JAX, it is an :class:`EncoderDecoder` over an
:class:`IdentityBackbone`, so whole and slide inference, the losses and
the train step are the same code. The head gets the image's channel
count as ``feature_channels``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..builder import BACKBONES, SEGMENTORS
from .encoder_decoder import EncoderDecoder


@BACKBONES.register_module()
class IdentityBackbone(nn.Module):
    """Pass-through backbone: the head sees the raw NCHW image."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = in_channels

    def forward(self, x, generator=None):
        return x


@SEGMENTORS.register_module()
class EncoderDecoderFull(EncoderDecoder):
    """An identity backbone of 3 channels → ``decode_head``;
    ``pretrained`` and any other keyword are ignored, as in JAX."""

    def __init__(self, decode_head, pretrained=None, train_cfg=None,
                 test_cfg=None, init_cfg=None, **kwargs):
        super().__init__(
            backbone=dict(type='IdentityBackbone'),
            decode_head=decode_head, train_cfg=train_cfg, test_cfg=test_cfg,
            pretrained=None, init_cfg=init_cfg)

    @torch.inference_mode()
    def extract_feat(self, img):
        """The head's input, which is the NHWC image itself (JAX's
        ``extract``), not a list of levels."""
        return self._as_input(img)
