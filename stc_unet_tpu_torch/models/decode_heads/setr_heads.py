"""SETR's heads and Segmenter's mask transformer
(≙ ``stc_unet_tpu/models/decode_heads/setr_heads.py``).

``SETRUPHead``: a LayerNorm over the token channels (``norm``, eps 1e-6,
flax's default), then ``num_convs`` ConvModules each followed by a
bilinear upsample by ``up_scale`` (mmseg's ``up_convs.{i}``, an
``nn.Sequential`` of the ConvModule and its upsample), the classifier.
``SETRMLAHead``: per level two 3x3 ConvModules at ``mla_channels`` and an
upsample (``up_convs.{i}.{0,1}``), the levels concatenated, the
classifier. ``SegmenterMaskTransformerHead``: the patch tokens projected
(``dec_proj``), the learned class embeddings (``cls_emb``) appended after
them, pre-LN transformer layers (the ViT's, ``layers.{i}``), a LayerNorm,
the patch and class projections L2-normalised and multiplied into masks,
a LayerNorm over the classes; it has no classifier. NCHW; the keys are
mmseg v0.29.1's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..backbones.vit import TransformerEncoderLayer
from ..bricks import ConvModule, LayerNorm, Linear
from ..builder import HEADS
from .decode_head import BaseDecodeHead
from .fpn_head import Upsample


@HEADS.register_module()
class SETRUPHead(BaseDecodeHead):
    """SETR's naive (``num_convs=1``) and progressive upsampling head (JAX
    ``setr_heads.py:18``)."""

    def __init__(self, num_convs: int = 1, up_scale: int = 4,
                 kernel_size: int = 3,
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        assert kernel_size in (1, 3), 'kernel_size must be 1 or 3.'
        super().__init__(**kwargs)
        c_in = self._input_channels(feature_channels)
        self.norm = LayerNorm(c_in, eps=1e-6)
        self.up_convs = nn.ModuleList([
            nn.Sequential(
                ConvModule(c_in if i == 0 else self.channels, self.channels,
                           kernel_size, padding=kernel_size // 2,
                           conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                           act_cfg=self.act_cfg),
                Upsample(up_scale, self.align_corners))
            for i in range(num_convs)])
        self._init_cls_seg(self.channels)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        x = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        for up in self.up_convs:
            x = up(x)
        return self.cls_seg(x, generator)


@HEADS.register_module()
class SETRMLAHead(BaseDecodeHead):
    """SETR's multi-level aggregation head (JAX ``setr_heads.py:47``) over
    the levels of ``in_index`` (``input_transform='multiple_select'``)."""

    def __init__(self, mla_channels: int = 128, up_scale: int = 4,
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        kwargs.setdefault('in_index', (0, 1, 2, 3))
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        assert self.channels == len(self.in_channels) * mla_channels, \
            (f'channels ({self.channels}) must equal len(in_channels) '
             f'({len(self.in_channels)}) * mla_channels ({mla_channels})')
        cfg = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                   act_cfg=self.act_cfg)
        self.up_convs = nn.ModuleList([
            nn.Sequential(
                ConvModule(c, mla_channels, 3, padding=1, **cfg),
                ConvModule(mla_channels, mla_channels, 3, padding=1, **cfg),
                Upsample(up_scale, self.align_corners))
            for c in self._level_widths(feature_channels)])
        self._init_cls_seg(self.channels)

    def forward(self, inputs, generator=None):
        inputs = self._transform_inputs(inputs)
        out = torch.cat([up(x) for up, x in zip(self.up_convs, inputs)], 1)
        return self.cls_seg(out, generator)


@HEADS.register_module()
class SegmenterMaskTransformerHead(BaseDecodeHead):
    """Segmenter's mask transformer (JAX ``setr_heads.py:81``). As in JAX,
    every layer takes the same ``drop_path_rate`` (mmseg's rise linearly
    from 0) and their LayerNorms eps 1e-6 (mmseg's ``norm_cfg`` LN 1e-5);
    ``decoder_norm`` and ``mask_norm`` take 1e-5. Masks come out (N, K,
    h, w) for the K classes."""

    def __init__(self, num_layers: int = 2, num_heads: int = 12,
                 embed_dims: int = 768, mlp_ratio: int = 4,
                 drop_path_rate: float = 0.1, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 feature_channels: Optional[Sequence[int]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.dec_proj = Linear(self._input_channels(feature_channels),
                               embed_dims)
        self.cls_emb = nn.Parameter(torch.zeros(1, self.num_classes,
                                                embed_dims))
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dims, num_heads,
                                    int(embed_dims * float(mlp_ratio)), True,
                                    drop_rate, attn_drop_rate, drop_path_rate,
                                    1e-6)
            for _ in range(num_layers)])
        self.decoder_norm = LayerNorm(embed_dims, eps=1e-5)
        self.patch_proj = Linear(embed_dims, embed_dims, bias=False)
        self.classes_proj = Linear(embed_dims, embed_dims, bias=False)
        self.mask_norm = LayerNorm(self.num_classes, eps=1e-5)

    def reset_parameters(self, generator: torch.Generator):
        """The class embeddings at std 0.02."""
        self.cls_emb.copy_(torch.empty(self.cls_emb.shape).normal_(
            0, 0.02, generator=generator))

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        b, c, h, w = x.shape
        k = self.num_classes
        x = self.dec_proj(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        x = torch.cat([x, self.cls_emb.expand(b, -1, -1).to(x.dtype)], 1)
        for layer in self.layers:
            x = layer(x, generator)
        x = self.decoder_norm(x)
        patches = self.patch_proj(x[:, :-k])
        classes = self.classes_proj(x[:, -k:])
        patches = patches / torch.linalg.vector_norm(patches, dim=-1,
                                                     keepdim=True)
        classes = classes / torch.linalg.vector_norm(classes, dim=-1,
                                                     keepdim=True)
        masks = self.mask_norm(patches @ classes.transpose(1, 2))
        return masks.reshape(b, h, w, k).permute(0, 3, 1, 2)
