"""VisionTransformer backbone (≙ ``stc_unet_tpu/models/backbones/vit.py``).

The modules are laid out as the reference fork's (mmseg v0.29.1
``backbones/vit.py``), so the ``state_dict`` keys are a fork ``.pth``'s:
``patch_embed.projection``, ``cls_token``, ``pos_embed``,
``layers.{i}.ln1``, ``layers.{i}.attn.attn.in_proj_{weight,bias}`` and
``.attn.attn.out_proj`` (torch ``nn.MultiheadAttention``'s parameters),
``layers.{i}.ln2``, ``layers.{i}.ffn.layers.0.0`` and ``.ffn.layers.1``,
and ``ln1`` for the final norm.

The image is padded bottom and right to a patch multiple and embedded by
a strided conv; the cls token leads the tokens and the position
embedding is added, its grid resized (``interpolate_mode``, bicubic by
default, ``align_corners=False``) whenever the token grid is not
``img_size / patch_size`` a side. Pre-LN blocks: attention in plain
matmuls and a softmax (the JAX module's einsums, no kernel), exact-GELU
FFN, drop-path rates rising linearly from 0. The features of
``out_indices`` (an int or a sequence; negative ones count from the end;
mmseg's default -1, the last layer, after ``final_norm``) come back NCHW,
with the cls token beside each as a tuple under ``output_cls_token``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import resize
from ..bricks import Dropout, LayerNorm, Linear
from ..builder import BACKBONES
from ..utils.swin_core import DropPath
from .swin import _ITEM_20, FFN, PatchEmbed


class PackedAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (the packed
    ``in_proj_weight`` and ``in_proj_bias``, ``out_proj``), batch-first;
    q, k and v are rows [0, C), [C, 2C), [2C, 3C) of the packed in_proj,
    the JAX ``qkv`` Dense transposed. Everything is computed in x's
    dtype, as ``nn.Dense(dtype=x.dtype)`` does; the scores are
    ``q kᵀ · head_dim^-1/2``, then dropout (``attn_drop``) on the
    softmax. ``out_proj`` has a bias whatever ``qkv_bias`` says, as the
    JAX ``proj`` has (the fork's follows ``qkv_bias``)."""

    def __init__(self, embed_dims: int, num_heads: int, qkv_bias: bool,
                 attn_drop: float):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims)) \
            if qkv_bias else None
        self.out_proj = Linear(embed_dims, embed_dims)
        self.attn_drop = Dropout(attn_drop)

    def reset_parameters(self, generator: torch.Generator):
        """Xavier uniform for the packed in_proj, its bias 0."""
        c3, c = self.in_proj_weight.shape
        bound = math.sqrt(6.0 / (c + c3))
        self.in_proj_weight.copy_(torch.empty(c3, c).uniform_(
            -bound, bound, generator=generator))
        if self.in_proj_bias is not None:
            self.in_proj_bias.zero_()

    def forward(self, x, generator=None):
        b, n, c = x.shape
        h = self.num_heads
        bias = None if self.in_proj_bias is None else \
            self.in_proj_bias.to(x.dtype)
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), bias)
        q, k, v = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(q @ k.transpose(-2, -1) * (c // h) ** -0.5, -1)
        out = self.attn_drop(attn, generator) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class VitAttention(nn.Module):
    """mmcv's ``MultiheadAttention`` of a block: the attention
    (``attn``), dropout on its projection (``proj_drop``), the block's
    first DropPath (``dropout_layer``) and the identity added."""

    def __init__(self, embed_dims: int, num_heads: int, qkv_bias: bool,
                 attn_drop: float, proj_drop: float, drop_path: float):
        super().__init__()
        self.attn = PackedAttention(embed_dims, num_heads, qkv_bias,
                                    attn_drop)
        self.proj_drop = Dropout(proj_drop)
        self.dropout_layer = DropPath(drop_path)

    def forward(self, x, identity, generator=None):
        out = self.proj_drop(self.attn(x, generator), generator)
        return identity + self.dropout_layer(out, generator)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN attention and FFN, each with its residual. The LayerNorms
    carry the JAX module's names (``paramwise_name``) for the
    optimizer's ``custom_keys``."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int, qkv_bias: bool, drop_rate: float,
                 attn_drop_rate: float, drop_path_rate: float, eps: float):
        super().__init__()
        self.ln1 = LayerNorm(embed_dims, eps=eps)
        self.ln1.paramwise_name = 'norm1'
        self.attn = VitAttention(embed_dims, num_heads, qkv_bias,
                                 attn_drop_rate, drop_rate, drop_path_rate)
        self.ln2 = LayerNorm(embed_dims, eps=eps)
        self.ln2.paramwise_name = 'norm2'
        self.ffn = FFN(embed_dims, feedforward_channels, drop_rate,
                       drop_path_rate)

    def forward(self, x, generator=None):
        x = self.attn(self.ln1(x), x, generator)
        return self.ffn(self.ln2(x), x, generator)


@BACKBONES.register_module()
class VisionTransformer(nn.Module):
    """ViT backbone in mmseg's vocabulary (JAX ``vit.py:72``); returns
    the NCHW features of ``out_indices``, whose widths ``out_channels``
    lists (one a layer index the layers reach).

    As in JAX: ``img_size`` (an int or a square tuple) fixes the position
    grid, ``drop_rate`` drops after the position embedding, on the
    attention's projection and in the FFN, ``attn_drop_rate`` on the
    attention, the LayerNorms take ``norm_cfg``'s eps (1e-6 without it),
    ``norm_eval`` and ``with_cp`` change nothing. Where the JAX module
    accepts a field and ignores it, and the fork's module does not, the
    port refuses it: ``patch_norm``, ``pre_norm``, ``num_fcs`` other than
    2, ``patch_pad`` other than ``'corner'``, an ``act_cfg`` other than
    GELU, a ``norm_cfg`` other than LN, a non-square ``img_size``. A
    ``pretrained`` path or a ``Pretrained`` ``init_cfg`` raises too (item
    20). Unlike JAX, ``out_indices`` defaults to mmseg's -1, the last
    layer: JAX's (9, 14, 19, 23) reads layer 9 of the stock 12-layer
    Segmenter, whose ``final_norm`` then reaches no output."""

    def __init__(self, img_size=224, patch_size: int = 16,
                 in_channels: int = 3, embed_dims: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 out_indices: Union[int, Sequence[int]] = -1,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 with_cls_token: bool = True, output_cls_token: bool = False,
                 final_norm: bool = False, interpolate_mode: str = 'bicubic',
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, patch_norm: bool = False,
                 patch_pad: str = 'corner', pre_norm: bool = False,
                 norm_eval: bool = False, num_fcs: int = 2,
                 with_cp: bool = False, pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # the JAX module's construction-time checks (vit.py:104-112)
        if isinstance(img_size, (tuple, list)):
            assert len(img_size) <= 2, \
                f'img_size tuple length must be <= 2, got {img_size}'
        elif not isinstance(img_size, int):
            raise TypeError('img_size must be an int or a tuple, '
                            f'got {type(img_size).__name__}')
        if not isinstance(out_indices, (int, list, tuple)):
            raise TypeError('out_indices must be an int, list or tuple, '
                            f'got {type(out_indices).__name__}')
        if pretrained is not None:
            assert init_cfg is None, \
                'init_cfg and pretrained cannot be specified at the same time'
            if not isinstance(pretrained, str):
                raise TypeError('pretrained must be a str path or None, '
                                f'got {type(pretrained).__name__}')
        assert with_cls_token or not output_cls_token, \
            'with_cls_token must be True when output_cls_token is True'
        if pretrained is not None or (isinstance(init_cfg, dict) and
                                      init_cfg.get('type') == 'Pretrained'):
            raise NotImplementedError(f'a pretrained backbone {_ITEM_20}')
        if isinstance(out_indices, int):
            out_indices = (out_indices,)
        ignored = dict(patch_norm=patch_norm, pre_norm=pre_norm,
                       num_fcs=num_fcs != 2, patch_pad=patch_pad != 'corner',
                       act_cfg=(act_cfg or {}).get('type', 'GELU') != 'GELU',
                       norm_cfg=(norm_cfg or {}).get('type', 'LN') != 'LN')
        if isinstance(img_size, (tuple, list)):
            ignored['img_size'] = len(set(img_size)) > 1
            img_size = img_size[0]
        for name, set_ in ignored.items():
            if set_:
                raise NotImplementedError(
                    f'{name}: the JAX module ignores it, the fork does not')
        self.patch_size, self.embed_dims = patch_size, embed_dims
        self.side = img_size // patch_size
        self.with_cls_token = with_cls_token
        self.output_cls_token = output_cls_token
        self.interpolate_mode = interpolate_mode
        self.out_indices = tuple(i if i >= 0 else num_layers + i
                                 for i in out_indices)
        eps = float((norm_cfg or {}).get('eps', 1e-6))
        self.patch_embed = PatchEmbed(in_channels, embed_dims, patch_size,
                                      patch_norm=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dims))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.side ** 2 + 1,
                                                  embed_dims))
        self.drop_after_pos = Dropout(drop_rate)
        dpr = np.linspace(0, drop_path_rate, num_layers)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dims, num_heads,
                                    int(embed_dims * mlp_ratio), qkv_bias,
                                    drop_rate, attn_drop_rate,
                                    float(dpr[i]), eps)
            for i in range(num_layers)])
        if final_norm:
            self.ln1 = LayerNorm(embed_dims, eps=eps)
            self.ln1.paramwise_name = 'norm1_final'
        self.out_channels = [embed_dims] * sum(
            0 <= i < num_layers for i in self.out_indices)

    def reset_parameters(self, generator: torch.Generator):
        """The cls token and the position embedding at std 0.02."""
        for p in (self.cls_token, self.pos_embed):
            p.copy_(torch.empty(p.shape).normal_(0, 0.02,
                                                 generator=generator))

    def _position(self, h: int, w: int):
        """(1, 1 + h·w, C): the cls position, then the grid resized to h×w
        where it is not the ``img_size`` one."""
        grid = self.pos_embed[:, 1:].reshape(1, self.side, self.side, -1)
        if (h, w) != (self.side, self.side):
            grid = resize(grid, size=(h, w), mode=self.interpolate_mode,
                          align_corners=False, warning=False)
        return torch.cat([self.pos_embed[:, :1], grid.reshape(1, h * w, -1)],
                         1)

    def forward(self, x, generator=None):
        tokens, (h, w) = self.patch_embed(x)
        b = tokens.shape[0]
        cls = self.cls_token.expand(b, -1, -1).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], 1) + \
            self._position(h, w).to(tokens.dtype)
        tokens = self.drop_after_pos(tokens, generator)
        if not self.with_cls_token:
            tokens = tokens[:, 1:]
        outs = []
        for i, layer in enumerate(self.layers):
            tokens = layer(tokens, generator)
            if i == len(self.layers) - 1 and hasattr(self, 'ln1'):
                tokens = self.ln1(tokens)
            if i in self.out_indices:
                t = tokens[:, 1:] if self.with_cls_token else tokens
                feat = t.reshape(b, h, w, -1).permute(0, 3, 1, 2)
                outs.append((feat, tokens[:, 0]) if self.output_cls_token
                            else feat)
        return outs
