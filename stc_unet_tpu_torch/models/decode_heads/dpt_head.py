"""DPTHead (≙ ``stc_unet_tpu/models/decode_heads/dpt_head.py``): the ViT's
token maps reassembled into a pyramid and fused from the deepest level
up.

``ReassembleBlocks``: per level the cls token read out (``'ignore'``
drops it, ``'add'`` adds it, ``'project'`` concatenates it to every
token and maps them back by a Linear and an exact GELU,
``readout_projects.{i}``), a 1x1 ``projects.{i}`` and
``resize_layers.{i}``: transposed convs of kernel = stride 4 and 2, the
identity, a 3x3 stride-2 conv (factors 4, 2, 1, 0.5 of four levels; with
another number of levels, the identity). ``FeatureFusionBlock``: the
skip (resized bilinearly, ``align_corners=False``, when its size is not
the input's) through ``res_conv_unit1`` added, ``res_conv_unit2``, a 2x
bilinear upsample (``align_corners=True``), a 1x1 ``project``.
``PreActResidualConvUnit``: ReLU, 3x3 ``conv1`` (and its norm), ReLU,
3x3 ``conv2`` (and its norm), plus the input. NCHW; the keys are mmseg
v0.29.1's.

As in JAX, the residual units' convs take a bias when there is no norm
(mmseg's have none), the first fusion block has no ``res_conv_unit1``
(mmseg sets it to None), and ``projects`` and the readout are sized from
the levels' own widths.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import Conv2d, ConvModule, ConvTranspose2d, Linear
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .psp_head import resize_nchw


class ReassembleBlocks(nn.Module):
    """ViT token maps (or ``(map, cls_token)`` pairs) into four pyramid
    levels at strides 4, 8, 16 and 32 of a stride-16 ViT."""

    def __init__(self, in_channels: Sequence[int],
                 out_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = 'ignore'):
        super().__init__()
        self.readout_type = readout_type
        self.projects = nn.ModuleList([
            ConvModule(c_in, c, 1) for c_in, c in zip(in_channels,
                                                      out_channels)])
        c = list(out_channels)
        if len(c) == 4:
            self.resize_layers = nn.ModuleList([
                ConvTranspose2d(c[0], c[0], 4, stride=4),
                ConvTranspose2d(c[1], c[1], 2, stride=2), nn.Identity(),
                Conv2d(c[3], c[3], 3, stride=2, padding=1)])
        else:
            self.resize_layers = nn.ModuleList([nn.Identity() for _ in c])
        if readout_type == 'project':
            self.readout_projects = nn.ModuleList([
                nn.Sequential(Linear(2 * c_in, c_in), nn.GELU())
                for c_in in in_channels])

    def forward(self, inputs):
        outs = []
        for i, x in enumerate(inputs):
            if isinstance(x, (tuple, list)):
                x, cls_token = x
                if self.readout_type == 'project':
                    b, c, h, w = x.shape
                    tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
                    readout = cls_token[:, None, :].expand_as(tokens)
                    tokens = self.readout_projects[i](
                        torch.cat([tokens, readout], -1))
                    x = tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)
                elif self.readout_type == 'add':
                    x = x + cls_token[:, :, None, None]
            outs.append(self.resize_layers[i](self.projects[i](x)))
        return outs


class PreActResidualConvUnit(nn.Module):
    """x + conv2(relu(conv1(relu(x)))), each conv a 3x3 ConvModule with
    ``norm_cfg``'s norm."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None):
        super().__init__()
        self.conv1 = ConvModule(channels, channels, 3, padding=1,
                                norm_cfg=norm_cfg)
        self.conv2 = ConvModule(channels, channels, 3, padding=1,
                                norm_cfg=norm_cfg)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """A level fused into the map from above (``skip``), then upsampled
    2x; ``with_skip=False`` for the deepest level, which has none."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None,
                 with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.res_conv_unit1 = PreActResidualConvUnit(channels, norm_cfg)
        self.res_conv_unit2 = PreActResidualConvUnit(channels, norm_cfg)
        self.project = ConvModule(channels, channels, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            if skip.shape[2:] != x.shape[2:]:
                skip = resize_nchw(skip, x.shape[2:], False)
            x = x + self.res_conv_unit1(skip)
        x = self.res_conv_unit2(x)
        x = resize_nchw(x, (2 * x.shape[2], 2 * x.shape[3]), True)
        return self.project(x)


@HEADS.register_module()
class DPTHead(BaseDecodeHead):
    """Dense prediction transformer head (JAX ``dpt_head.py:103``).
    ``input_transform`` is not defaulted: a config must say
    ``'multiple_select'``, as mmseg's must. ``expand_channels`` scales level
    i's ``post_process_channels`` by 2^i; ``convs.{i}`` are 3x3 without a
    bias; ``project`` is a 3x3 ConvModule with the head's norm and its
    activation (ReLU where the head has none)."""

    def __init__(self, embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 readout_type: str = 'ignore', patch_size: int = 16,
                 expand_channels: bool = False,
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        assert readout_type in ('ignore', 'add', 'project'), \
            f'invalid readout_type {readout_type!r}'
        kwargs.setdefault('in_index', (0, 1, 2, 3))
        super().__init__(**kwargs)
        ppc = [int(c * 2 ** i) if expand_channels else int(c)
               for i, c in enumerate(post_process_channels)]
        self.reassemble_blocks = ReassembleBlocks(
            self._level_widths(feature_channels), ppc, readout_type)
        self.convs = nn.ModuleList([
            ConvModule(c, self.channels, 3, padding=1, bias=False)
            for c in ppc])
        self.fusion_blocks = nn.ModuleList([
            FeatureFusionBlock(self.channels, self.norm_cfg, with_skip=i > 0)
            for i in range(len(ppc))])
        self.project = ConvModule(
            self.channels, self.channels, 3, padding=1,
            norm_cfg=self.norm_cfg, act_cfg=self.act_cfg or dict(type='ReLU'))
        self._init_cls_seg(self.channels)

    def forward(self, inputs, generator=None):
        x = self.reassemble_blocks(self._transform_inputs(inputs))
        x = [conv(f) for conv, f in zip(self.convs, x)]
        out = self.fusion_blocks[0](x[-1])
        for i in range(1, len(x)):
            out = self.fusion_blocks[i](out, x[-(i + 1)])
        return self.cls_seg(self.project(out), generator)
