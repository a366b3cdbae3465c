"""MultiLevelNeck, Feature2Pyramid and MLANeck, the necks of the ViT
family (≙ ``stc_unet_tpu/models/necks/misc_necks.py``). NCHW; the keys
are mmseg's (``multilevel_neck.py``, ``featurepyramid.py``,
``mla_neck.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn

from ..bricks import BatchNorm, ConvModule, ConvTranspose2d, LayerNorm
from ..builder import NECKS
from ..decode_heads.psp_head import resize_nchw
from .fpn import check_widths


@NECKS.register_module()
class MultiLevelNeck(nn.Module):
    """A 1x1 ``lateral_convs.{i}`` on each input, then per scale the
    input of that index (the one input, if there is one) resized to
    ``int(side · scale)`` (bilinear, ``align_corners=False``; scale 1 is
    left as it is) and a 3x3 ``convs.{i}`` (JAX ``misc_necks.py:17``).
    ``norm_cfg`` and ``act_cfg`` default to None: no norm, no
    activation."""

    def __init__(self, in_channels: Sequence[int] = (768,),
                 out_channels: int = 768,
                 scales: Sequence[float] = (0.5, 1, 2, 4),
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 feature_channels: Optional[Sequence[int]] = None):
        super().__init__()
        widths = check_widths(in_channels, feature_channels)
        self.scales = tuple(scales)
        cfg = dict(norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.lateral_convs = nn.ModuleList([
            ConvModule(c, out_channels, 1, **cfg) for c in widths])
        self.convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, padding=1, **cfg)
            for _ in self.scales])
        self.out_channels = [out_channels] * len(self.scales)

    def forward(self, inputs):
        assert len(inputs) == len(self.lateral_convs)
        inputs = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        outs = []
        for i, (scale, conv) in enumerate(zip(self.scales, self.convs)):
            x = inputs[i] if len(inputs) > 1 else inputs[0]
            if scale != 1:
                x = resize_nchw(x, (int(x.shape[2] * scale),
                                    int(x.shape[3] * scale)), False)
            outs.append(conv(x))
        return outs


@NECKS.register_module()
class Feature2Pyramid(nn.Module):
    """ViT features into a pyramid (JAX ``misc_necks.py:52``): rescale 4
    is ``upsample_4x`` (a 2x2 stride-2 transposed conv, BN, exact GELU,
    another), 2 ``upsample_2x`` (one), 1 the identity, 0.5 and 0.25 max
    pools of 2 and 4; any other factor raises ``KeyError``. mmseg holds
    one ``upsample_4x`` and one ``upsample_2x``, so a factor of 4 or 2
    given twice (two modules in JAX) raises. The BN is the JAX brick's
    (eps 1e-5, momentum 0.1): a ``norm_cfg`` other than BN, which JAX
    ignores, raises."""

    def __init__(self, embed_dim: int = 768,
                 rescales: Sequence[float] = (4, 2, 1, 0.5),
                 norm_cfg: Optional[dict] = None,
                 feature_channels: Optional[Sequence[int]] = None):
        super().__init__()
        for k in rescales:
            if k not in (4, 2, 1, 0.5, 0.25):
                raise KeyError(f'invalid {k} for feature2pyramid')
        for k in (4, 2):
            if list(rescales).count(k) > 1:
                raise ValueError(f'rescale {k} twice: mmseg holds one '
                                 f'module for it')
        if norm_cfg is not None and (
                norm_cfg.get('type') not in ('BN', 'SyncBN') or
                set(norm_cfg) - {'type', 'requires_grad'}):
            raise NotImplementedError(
                f'norm_cfg {norm_cfg}: the JAX module takes BN at eps 1e-5 '
                'whatever it says')
        check_widths([embed_dim] * len(rescales), feature_channels)
        self.rescales = tuple(rescales)
        c = embed_dim
        if 4 in self.rescales:
            self.upsample_4x = nn.Sequential(
                ConvTranspose2d(c, c, 2, stride=2), BatchNorm(c), nn.GELU(),
                ConvTranspose2d(c, c, 2, stride=2))
        if 2 in self.rescales:
            self.upsample_2x = nn.Sequential(ConvTranspose2d(c, c, 2,
                                                             stride=2))
        self.downsample_2x = nn.MaxPool2d(2, 2)
        self.downsample_4x = nn.MaxPool2d(4, 4)
        self.out_channels = [c] * len(self.rescales)

    def forward(self, inputs):
        assert len(inputs) == len(self.rescales)
        ops = {4: getattr(self, 'upsample_4x', None),
               2: getattr(self, 'upsample_2x', None),
               1: lambda x: x, 0.5: self.downsample_2x,
               0.25: self.downsample_4x}
        return [ops[k](x) for k, x in zip(self.rescales, inputs)]


class MLAModule(nn.Module):
    """A 1x1 ``channel_proj.{i}`` a level, the cumulative sums from the
    top level down (m_top = p_top, then m_i = m_(i+1) + p_i), and a 3x3
    ``feat_extract.{i}`` on each, in that top-first order."""

    def __init__(self, in_channels, out_channels, norm_cfg, act_cfg):
        super().__init__()
        cfg = dict(norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.channel_proj = nn.ModuleList([
            ConvModule(c, out_channels, 1, **cfg) for c in in_channels])
        self.feat_extract = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, padding=1, **cfg)
            for _ in in_channels])

    def forward(self, inputs):
        feats = [proj(x) for proj, x in zip(self.channel_proj, inputs)]
        agg, prev = [], None
        for f in feats[::-1]:
            prev = f if prev is None else prev + f
            agg.append(prev)
        return [conv(x) for conv, x in zip(self.feat_extract, agg)]


@NECKS.register_module()
class MLANeck(nn.Module):
    """SETR's multi-level aggregation (JAX ``misc_necks.py:100``): a
    LayerNorm over each level's channels (``norm.{i}``, eps 1e-6, flax's
    default and mmseg's ``mla_neck``; normalised in f32, cast back), then
    :class:`MLAModule` (``mla``). The outputs come top level first."""

    def __init__(self, in_channels: Sequence[int] = (1024, 1024, 1024, 1024),
                 out_channels: int = 256, norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 feature_channels: Optional[Sequence[int]] = None):
        super().__init__()
        widths = check_widths(in_channels, feature_channels)
        self.norm = nn.ModuleList([LayerNorm(c, eps=1e-6) for c in widths])
        self.mla = MLAModule(widths, out_channels, norm_cfg, act_cfg)
        self.out_channels = [out_channels] * len(widths)

    def forward(self, inputs):
        assert len(inputs) == len(self.norm)
        inputs = [norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                  for norm, x in zip(self.norm, inputs)]
        return self.mla(inputs)
