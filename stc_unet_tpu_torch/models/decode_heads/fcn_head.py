"""FCNHead (≙ ``stc_unet_tpu/models/decode_heads/fcn_head.py``).

``num_convs`` ``ConvModule``s of ``kernel_size`` at ``dilation``
(``convs.{i}``), then, with ``concat_input`` and at least one conv, a
``ConvModule`` over the input and their output concatenated
(``conv_cat``), and the classifier. NCHW; the keys are mmseg's. As in
JAX, ``num_convs=0`` takes neither convs nor ``conv_cat``: the
classifier sees the input (mmseg would still run ``conv_cat`` over the
input twice).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..bricks import ConvModule
from ..builder import HEADS
from .decode_head import BaseDecodeHead


@HEADS.register_module()
class FCNHead(BaseDecodeHead):
    """Fully convolutional head (JAX ``fcn_head.py:16``); the auxiliary
    head of the stock zoo."""

    def __init__(self, num_convs: int = 2, kernel_size: int = 3,
                 concat_input: bool = True, dilation: int = 1,
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        # the JAX module's checks (fcn_head.py:24-31)
        assert num_convs >= 0 and dilation > 0 and \
            isinstance(dilation, int), \
            f'invalid num_convs {num_convs} / dilation {dilation}'
        if num_convs == 0:
            in_channels = kwargs.get('in_channels', 64)
            assert (not isinstance(in_channels, (list, tuple)) and
                    in_channels == kwargs.get('channels', 64)), \
                'num_convs=0 requires in_channels == channels'
        super().__init__(**kwargs)
        self.num_convs, self.concat_input = num_convs, concat_input
        c_in = self._input_channels(feature_channels)
        padding = (kernel_size // 2) * dilation
        self.convs = nn.Sequential(*[
            ConvModule(c_in if i == 0 else self.channels, self.channels,
                       kernel_size, padding=padding, dilation=dilation,
                       conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                       act_cfg=self.act_cfg)
            for i in range(num_convs)])
        if concat_input and num_convs > 0:
            self.conv_cat = ConvModule(
                c_in + self.channels, self.channels, kernel_size,
                padding=kernel_size // 2, conv_cfg=self.conv_cfg,
                norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self._init_cls_seg(self.channels if num_convs > 0 else c_in)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        feats = self.convs(x)
        if hasattr(self, 'conv_cat'):
            feats = self.conv_cat(torch.cat([x, feats], 1))
        return self.cls_seg(feats, generator)
