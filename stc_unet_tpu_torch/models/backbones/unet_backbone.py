"""STC U-Net encoder backbone
(≙ ``stc_unet_tpu/models/backbones/unet_backbone.py``).

NCHW modules, run in ``channels_last``; attribute names follow the
reference fork, so ``state_dict`` keys are its keys
(``inc.conv.conv.0.weight``, ``down1.down_conv.1.conv.0.weight``,
``context_layer1_1.convs.0.0.weight``, ``aspp4.tr.0.ma.in_proj_weight``).

Dtype flow, as in the JAX package: in eval the MHA keeps its in_proj f32,
and JAX promotes ``bf16 @ f32`` to f32, so with a bf16 image x4, x5 (and
the decoder after them) run in f32. torch does not promote mixed dtypes in
``matmul``/``linear``, so the MHA casts explicitly. In training the in_proj
is cast to the activations' dtype (JAX ``unet_backbone.py:130-132``), so
with a bf16 image x4, x5 and the decoder stay bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ...ops.flash_attention import flash_attention
from ..bricks import BatchNorm, Conv2d, Linear
from ..builder import BACKBONES


def _double_conv(in_ch, out_ch):
    return nn.Sequential(
        Conv2d(in_ch, out_ch, 3, padding=1), BatchNorm(out_ch), nn.ReLU(),
        Conv2d(out_ch, out_ch, 3, padding=1), BatchNorm(out_ch), nn.ReLU())


class DoubleConv(nn.Module):
    """(conv3x3 → BN → ReLU) × 2."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = _double_conv(in_ch, out_ch)

    def forward(self, x):
        return self.conv(x)


class InConv(nn.Module):
    """The fork's input stage: a DoubleConv under ``conv``."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    """MaxPool(2) + DoubleConv."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.down_conv = nn.Sequential(nn.MaxPool2d(2),
                                       DoubleConv(in_ch, out_ch))

    def forward(self, x):
        return self.down_conv(x)


class KernelSelectAttention(nn.Module):
    """SK-style multi-kernel attention: 3/5/7 convs (+BN+ReLU), the pooled
    statistic as a sum of per-branch f32 means, FC bottleneck, per-kernel
    FC, softmax over the kernel axis, weighted branch sum."""

    def __init__(self, channel=512, kernels=(3, 5, 7), reduction=16,
                 group=1, L=32):
        super().__init__()
        d = max(L, channel // reduction)
        self.convs = nn.ModuleList([
            nn.Sequential(Conv2d(channel, channel, k, padding=k // 2,
                                 groups=group),
                          BatchNorm(channel), nn.ReLU())
            for k in kernels])
        self.fc = Linear(channel, d)
        self.fcs = nn.ModuleList([Linear(d, channel) for _ in kernels])

    def forward(self, x):
        conv_outs = [conv(x) for conv in self.convs]
        s = sum(h.float().mean(dim=(2, 3)) for h in conv_outs)   # (N, C)
        z = self.fc(s)
        att = torch.softmax(torch.stack([fc(z) for fc in self.fcs], 0), 0)
        out = 0.
        for i, h in enumerate(conv_outs):
            out = out + att[i][:, :, None, None].to(h.dtype) * h
        return out


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` parameters (packed in_proj +
    out_proj), batch-first input (N, L, C). The attention core is the JAX
    module's einsum path, ``softmax(q kᵀ / sqrt(hd)) v``, or with
    ``use_flash`` its flash path (JAX ``unet_backbone.py:141-150``): q, k, v
    cast to f32, ``flash_attention`` (kernels Lf, Ldkv and Ldq on the card)
    with ``sm_scale = 1 / sqrt(hd)`` multiplying the scores, and the result
    cast back to the projections' dtype. The flag has no parameters."""

    def __init__(self, embed_dim, num_heads, use_flash=False):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.use_flash = use_flash
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def reset_parameters(self, generator: torch.Generator):
        """Xavier uniform for the packed in_proj, its bias 0."""
        c3, c = self.in_proj_weight.shape
        bound = math.sqrt(6.0 / (c + c3))
        self.in_proj_weight.copy_(torch.empty(c3, c).uniform_(
            -bound, bound, generator=generator))
        self.in_proj_bias.zero_()

    def forward(self, q, k, v):
        c, h = self.embed_dim, self.num_heads
        hd = c // h
        w, b = self.in_proj_weight, self.in_proj_bias
        # training computes in q's dtype; eval keeps the in_proj f32, and
        # JAX promotes bf16 @ f32 to f32
        dt = q.dtype if self.training else torch.promote_types(q.dtype,
                                                               w.dtype)
        w, b = w.to(dt), b.to(dt)
        q = torch.matmul(q.to(dt), w[:c].t()) + b[:c]
        k = torch.matmul(k.to(dt), w[c:2 * c].t()) + b[c:2 * c]
        v = torch.matmul(v.to(dt), w[2 * c:].t()) + b[2 * c:]
        n, lq, lk = q.shape[0], q.shape[1], k.shape[1]
        q = q.reshape(n, lq, h, hd).transpose(1, 2)
        k = k.reshape(n, lk, h, hd).transpose(1, 2)
        v = v.reshape(n, lk, h, hd).transpose(1, 2)
        if self.use_flash:
            out = flash_attention(q.float(), k.float(), v.float(),
                                  sm_scale=1.0 / math.sqrt(hd)).to(q.dtype)
        else:
            # a divide by sqrt(hd) rounded to q's dtype, as the JAX module
            # does
            scale = torch.tensor(math.sqrt(hd), dtype=q.dtype).item()
            att = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) / scale,
                                -1)
            out = torch.matmul(att, v)
        out = out.transpose(1, 2).reshape(n, lq, c)
        return self.out_proj(out)


class TransformerLayer(nn.Module):
    """ViT layer without LayerNorm; the fork applies bias-free q/k/v
    Linears before the MHA's own in_proj."""

    def __init__(self, c, num_heads, use_flash=False):
        super().__init__()
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads, use_flash)
        self.fc1 = Linear(c, c, bias=False)
        self.fc2 = Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Tokenize HW → pos-embed Linear → N layers → un-tokenize (c1 ==
    c2 in the STC config, so the channel-matching conv is omitted)."""

    def __init__(self, c2, num_heads, num_layers, use_flash=False):
        super().__init__()
        self.c2 = c2
        self.linear = Linear(c2, c2)
        self.tr = nn.ModuleList([TransformerLayer(c2, num_heads, use_flash)
                                 for _ in range(num_layers)])

    def forward(self, x):
        n, c, h, w = x.shape
        assert c == self.c2, 'channel-matching conv not needed in STC config'
        p = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        p = p + self.linear(p)
        for layer in self.tr:
            p = layer(p)
        return p.reshape(n, h, w, c).permute(0, 3, 1, 2)


@BACKBONES.register_module()
class UnetBackbone(nn.Module):
    """5-scale U-Net encoder: channels [c0, c1, c2, c3, c3]; optional KSA
    residuals on x1..x3 and transformer residuals at x4/x5, whose attention
    takes the flash path with ``flash_attention``."""

    def __init__(self, in_channels: int = 3,
                 channel_list: Sequence[int] = (64, 128, 256, 512),
                 context_layer: Optional[str] = None,
                 coord_att: bool = False, transformer_block: bool = False,
                 flash_attention: bool = False,
                 init_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None):
        super().__init__()
        cl = list(channel_list)
        self.context_layer = context_layer
        self.transformer_block = transformer_block
        self.out_channels = [cl[0], cl[1], cl[2], cl[3], cl[3]]
        self.inc = InConv(in_channels, cl[0])
        self.down1 = Down(cl[0], cl[1])
        self.down2 = Down(cl[1], cl[2])
        self.down3 = Down(cl[2], cl[3])
        self.down4 = Down(cl[3], cl[3])
        if context_layer == 'kernelselect':
            self.context_layer1_1 = KernelSelectAttention(cl[0])
            self.context_layer2_1 = KernelSelectAttention(cl[1])
            self.context_layer3_1 = KernelSelectAttention(cl[2])
        if transformer_block:
            self.aspp4 = TransformerBlock(cl[3], 2, 4, flash_attention)
            self.aspp5 = TransformerBlock(cl[3], 2, 4, flash_attention)

    def forward(self, x, generator=None):
        """The 5 scales; the encoder draws nothing from ``generator``."""
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        if self.context_layer == 'kernelselect':
            x1 = x1 + self.context_layer1_1(x1)
            x2 = x2 + self.context_layer2_1(x2)
            x3 = x3 + self.context_layer3_1(x3)
        if self.transformer_block:
            x4 = self.aspp4(x4) + x4
            x5 = self.aspp5(x5) + x5
        return [x1, x2, x3, x4, x5]
