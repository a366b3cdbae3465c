"""FPNHead (≙ ``stc_unet_tpu/models/decode_heads/fpn_head.py``), the
semantic FPN head: a conv-and-upsample pyramid a level, the levels
summed, the classifier.

Level i runs ``max(1, log2(stride_i / stride_0))`` 3x3 ``ConvModule``s,
each followed, on a level whose stride is not the first's, by a 2x
bilinear upsample. Each level is mmseg's ``nn.Sequential``
(``scale_heads.{i}``), so from level 1 on the convs sit at 0, 2, 4 and
the upsamples between them. As in JAX, the levels are summed as they
come, without resizing them to the first one's size. NCHW.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch.nn as nn

from stc_unet_tpu_torch.ops import resize
from ..bricks import ConvModule
from ..builder import HEADS
from .decode_head import BaseDecodeHead


class Upsample(nn.Module):
    """A bilinear upsample of an NCHW map by ``scale_factor`` (mmseg's
    ``Upsample``; the literal factor, as the JAX ``resize`` takes it)."""

    def __init__(self, scale_factor: int, align_corners: bool):
        super().__init__()
        self.scale_factor, self.align_corners = scale_factor, align_corners

    def forward(self, x):
        return resize(x.permute(0, 2, 3, 1), scale_factor=self.scale_factor,
                      mode='bilinear', align_corners=self.align_corners,
                      warning=False).permute(0, 3, 1, 2)


@HEADS.register_module()
class FPNHead(BaseDecodeHead):
    """Panoptic-FPN style head (JAX ``fpn_head.py:16``) over the levels
    of ``in_index`` (``input_transform='multiple_select'``)."""

    def __init__(self, feature_strides: Sequence[int] = (4, 8, 16, 32),
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        kwargs.setdefault('in_index', (0, 1, 2, 3))
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        widths = self._level_widths(feature_channels)
        assert len(feature_strides) == len(widths)
        self.feature_strides = tuple(feature_strides)
        cfg = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                   act_cfg=self.act_cfg)
        self.scale_heads = nn.ModuleList()
        for i, stride in enumerate(self.feature_strides):
            length = max(1, int(np.log2(stride) -
                                np.log2(self.feature_strides[0])))
            layers = []
            for k in range(length):
                layers.append(ConvModule(widths[i] if k == 0 else
                                         self.channels, self.channels, 3,
                                         padding=1, **cfg))
                if stride != self.feature_strides[0]:
                    layers.append(Upsample(2, self.align_corners))
            self.scale_heads.append(nn.Sequential(*layers))
        self._init_cls_seg(self.channels)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        assert len(x) == len(self.scale_heads)
        output = None
        for head, f in zip(self.scale_heads, x):
            f = head(f)
            output = f if output is None else output + f
        return self.cls_seg(output, generator)
