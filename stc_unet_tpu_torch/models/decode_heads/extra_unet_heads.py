"""The reference fork's extra live monolithic heads
(≙ ``stc_unet_tpu/models/decode_heads/extra_unet_heads.py``).

- :class:`ResUNet` (reference ``decode_heads/resunet_decoder.py:11``)
- :class:`LinkNet` (reference ``decode_heads/linknet.py:88``, its timm
  resnet18 encoder written out)
- :class:`MultiResUnet` (reference ``decode_heads/MultiResUnet_head.py:122``)

Like DC-UNet, each takes the image itself (``EncoderDecoderFull``), whose
channel count the segmentor gives as ``feature_channels``, and returns its
own output map without ``cls_seg``. The JAX modules' quirks are kept:
ResUNet's hard-wired 2-channel sigmoid output, LinkNet's log-softmax
output, MultiResUnet's affine-free BatchNorms, its one ``batch_norm1``
applied twice in ``Multiresblock`` and its weight-shared ``Respath``
chain. NCHW in ``channels_last``; torch modules need their input widths,
which the JAX modules infer, so each block is given the width it takes.
The keys follow the flax names.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import BatchNorm, Conv2d, ConvTranspose2d
from ..builder import HEADS
from .decode_head import BaseDecodeHead


# ---------------------------------------------------------------------------
# ResUNet
# ---------------------------------------------------------------------------

class ResidualConv(nn.Module):
    """BN → relu → conv3x3(s) → BN → relu → conv3x3, plus a conv3x3(s) +
    BN skip."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, features, 3, stride, padding)
        self.bn2 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.skip_conv = Conv2d(in_channels, features, 3, stride, 1)
        self.skip_bn = BatchNorm(features)

    def forward(self, x):
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return h + self.skip_bn(self.skip_conv(x))


@HEADS.register_module()
class ResUNet(BaseDecodeHead):
    """3-level residual U-Net. Its output is a 2-channel sigmoid map
    whatever ``num_classes`` says, as in the reference; ``channel`` (the
    reference's input width) is accepted and ignored."""

    def __init__(self, filters: Sequence[int] = (64, 128, 256, 512),
                 channel: int = 1, feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        f = list(filters)
        self.in_conv1 = Conv2d(feature_channels, f[0], 3, padding=1)
        self.in_bn = BatchNorm(f[0])
        self.in_conv2 = Conv2d(f[0], f[0], 3, padding=1)
        self.in_skip = Conv2d(feature_channels, f[0], 3, padding=1)
        self.res1 = ResidualConv(f[0], f[1], stride=2)
        self.res2 = ResidualConv(f[1], f[2], stride=2)
        self.bridge = ResidualConv(f[2], f[3], stride=2)
        self.up1 = ConvTranspose2d(f[3], f[3], 2, stride=2)
        self.up_res1 = ResidualConv(f[3] + f[2], f[2])
        self.up2 = ConvTranspose2d(f[2], f[2], 2, stride=2)
        self.up_res2 = ResidualConv(f[2] + f[1], f[1])
        self.up3 = ConvTranspose2d(f[1], f[1], 2, stride=2)
        self.up_res3 = ResidualConv(f[1] + f[0], f[0])
        self.out_conv = Conv2d(f[0], 2, 1)

    def forward(self, x, generator=None):
        h = self.in_conv2(F.relu(self.in_bn(self.in_conv1(x))))
        x1 = h + self.in_skip(x)
        x2 = self.res1(x1)
        x3 = self.res2(x2)
        x4 = self.bridge(x3)
        d = self.up_res1(torch.cat([self.up1(x4), x3], 1))
        d = self.up_res2(torch.cat([self.up2(d), x2], 1))
        d = self.up_res3(torch.cat([self.up3(d), x1], 1))
        return torch.sigmoid(self.out_conv(d))


# ---------------------------------------------------------------------------
# LinkNet
# ---------------------------------------------------------------------------

class _BasicBlock(nn.Module):
    """resnet18's BasicBlock: conv3x3(s)-bn-relu-conv3x3-bn, plus a
    1x1(s) conv + BN shortcut where the stride or the width changes;
    relu."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.down = stride != 1 or in_channels != features
        if self.down:
            self.down_conv = Conv2d(in_channels, features, 1, stride,
                                    bias=False)
            self.down_bn = BatchNorm(features)

    def forward(self, x):
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(h + x)


class _LinkDecoder(nn.Module):
    """1x1 reduce to C/4 → transposed conv → 1x1 expand, each + BN +
    relu."""

    def __init__(self, in_channels: int, out_features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1, output_padding: int = 0):
        super().__init__()
        quarter = in_channels // 4
        self.conv1 = Conv2d(in_channels, quarter, 1, bias=False)
        self.bn1 = BatchNorm(quarter)
        self.tp_conv = ConvTranspose2d(quarter, quarter, kernel, stride,
                                       padding, output_padding, bias=False)
        self.tp_bn = BatchNorm(quarter)
        self.conv2 = Conv2d(quarter, out_features, 1, bias=False)
        self.bn2 = BatchNorm(out_features)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.tp_bn(self.tp_conv(h)))
        return F.relu(self.bn2(self.conv2(h)))


@HEADS.register_module()
class LinkNet(BaseDecodeHead):
    """LinkNet over a resnet18 encoder (random weights, as every backbone
    of the port). Its output is the log-softmax over ``n_classes``
    channels, as in the reference."""

    _ENCODER = ((64, 1), (128, 2), (256, 2), (512, 2))

    def __init__(self, n_classes: int = 21, feature_channels: int = 3,
                 **kwargs):
        super().__init__(**kwargs)
        self.in_conv = Conv2d(feature_channels, 64, 7, 2, 3, bias=False)
        self.in_bn = BatchNorm(64)
        width = 64
        for i, (feat, stride) in enumerate(self._ENCODER):
            setattr(self, f'enc{i + 1}_0', _BasicBlock(width, feat, stride))
            setattr(self, f'enc{i + 1}_1', _BasicBlock(feat, feat))
            width = feat
        self.decoder4 = _LinkDecoder(512, 256, 3, 2, 1, 1)
        self.decoder3 = _LinkDecoder(256, 128, 3, 2, 1, 1)
        self.decoder2 = _LinkDecoder(128, 64, 3, 2, 1, 1)
        self.decoder1 = _LinkDecoder(64, 64, 3, 1, 1, 0)
        self.tp_conv1 = ConvTranspose2d(64, 32, 3, 2, 1, 1)
        self.tp_bn1 = BatchNorm(32)
        self.conv2 = Conv2d(32, 32, 3, padding=1)
        self.bn2 = BatchNorm(32)
        self.tp_conv2 = ConvTranspose2d(32, n_classes, 2, 2)

    def forward(self, x, generator=None):
        h = F.relu(self.in_bn(self.in_conv(x)))
        stem = F.max_pool2d(h, 3, 2, 1)           # -inf padding, as torch's
        h, feats = stem, []
        for i in range(len(self._ENCODER)):
            h = getattr(self, f'enc{i + 1}_0')(h)
            h = getattr(self, f'enc{i + 1}_1')(h)
            feats.append(h)
        e1, e2, e3, e4 = feats
        d4 = e3 + self.decoder4(e4)
        d3 = e2 + self.decoder3(d4)
        d2 = e1 + self.decoder2(d3)
        # decoder1 keeps the resolution; its residual is the pooled stem
        d1 = stem + self.decoder1(d2)
        y = F.relu(self.tp_bn1(self.tp_conv1(d1)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.log_softmax(self.tp_conv2(y), dim=1)


# ---------------------------------------------------------------------------
# MultiResUnet
# ---------------------------------------------------------------------------

class Conv2dBN(nn.Module):
    """conv → BN(affine=False) → relu, or no activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 2,
                 activation: str = 'relu', padding: int = 0):
        super().__init__()
        self.relu = activation == 'relu'
        self.conv1 = Conv2d(in_channels, features, kernel_size,
                            padding=padding)
        self.batchnorm = BatchNorm(features, affine=False)

    def forward(self, x):
        x = self.batchnorm(self.conv1(x))
        return F.relu(x) if self.relu else x


def _mrb_widths(unet_filters: int, alpha: float = 1.67):
    """A Multiresblock's three tower widths, each truncated."""
    w = unet_filters * alpha
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


def mrb_out_channels(unet_filters: int, alpha: float = 1.67) -> int:
    """A Multiresblock's output width: 51, 105, 212, 426 and 853 for
    ``filters=32`` at 1, 2, 4, 8 and 16 times."""
    return sum(_mrb_widths(unet_filters, alpha))


class Multiresblock(nn.Module):
    """3/5/7 receptive-field tower + a 1x1 shortcut. Its one
    ``batch_norm1`` runs twice, before and after the shortcut's add, as
    in the reference (so its running stats move twice a training
    forward)."""

    def __init__(self, in_channels: int, unet_filters: int,
                 alpha: float = 1.67):
        super().__init__()
        c3, c5, c7 = _mrb_widths(unet_filters, alpha)
        out = c3 + c5 + c7
        self.conv2d_bn_1x1 = Conv2dBN(in_channels, out, 1, activation='None')
        self.conv2d_bn_3x3 = Conv2dBN(in_channels, c3, 3, padding=1)
        self.conv2d_bn_5x5 = Conv2dBN(c3, c5, 3, padding=1)
        self.conv2d_bn_7x7 = Conv2dBN(c5, c7, 3, padding=1)
        self.batch_norm1 = BatchNorm(out, affine=False)

    def forward(self, x):
        shortcut = self.conv2d_bn_1x1(x)
        a = self.conv2d_bn_3x3(x)
        b = self.conv2d_bn_5x5(a)
        c = self.conv2d_bn_7x7(b)
        out = self.batch_norm1(torch.cat([a, b, c], 1))
        return self.batch_norm1(out + shortcut)


class Respath(nn.Module):
    """The residual skip chain. Past its first step, the loop runs the
    same ``common`` 1x1 and 3x3 blocks and ``batch_norm1``
    ``respath_length`` times (not ``length - 1``), as in the reference;
    a chain of length 1 has no common blocks."""

    def __init__(self, in_channels: int, filters: int, respath_length: int):
        super().__init__()
        self.respath_length = respath_length
        self.conv2d_bn_1x1 = Conv2dBN(in_channels, filters, 1,
                                      activation='None')
        self.conv2d_bn_3x3 = Conv2dBN(in_channels, filters, 3, padding=1)
        self.batch_norm1 = BatchNorm(filters, affine=False)
        if respath_length > 1:
            self.conv2d_bn_1x1_common = Conv2dBN(filters, filters, 1,
                                                 activation='None')
            self.conv2d_bn_3x3_common = Conv2dBN(filters, filters, 3,
                                                 padding=1)

    def forward(self, x):
        shortcut = self.conv2d_bn_1x1(x)
        x = self.batch_norm1(F.relu(self.conv2d_bn_3x3(x) + shortcut))
        if self.respath_length > 1:
            for _ in range(self.respath_length):
                shortcut = self.conv2d_bn_1x1_common(x)
                x = self.conv2d_bn_3x3_common(x)
                x = self.batch_norm1(F.relu(x + shortcut))
        return x


@HEADS.register_module()
class MultiResUnet(BaseDecodeHead):
    """MultiResUNet. ``nclasses`` output channels, through a sigmoid only
    when it is 1, as in the reference; ``channels`` (the reference's input
    width) is ``BaseDecodeHead``'s and unused. ``alpha`` is accepted and,
    as in JAX, not passed to the blocks, which keep 1.67."""

    _DOWN = ((1, 4), (2, 3), (4, 2), (8, 1))    # (width factor, respath)

    def __init__(self, filters: int = 32, nclasses: int = 1,
                 alpha: float = 1.67, feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        f, d = filters, mrb_out_channels
        self.nclasses = nclasses
        width = feature_channels
        for i, (mult, length) in enumerate(self._DOWN):
            setattr(self, f'multiresblock{i + 1}',
                    Multiresblock(width, f * mult))
            setattr(self, f'respath{i + 1}',
                    Respath(d(f * mult), f * mult, length))
            width = d(f * mult)
        self.multiresblock5 = Multiresblock(width, f * 16)
        width = d(f * 16)
        for i, mult in enumerate((8, 4, 2, 1)):
            setattr(self, f'upsample{i + 6}',
                    ConvTranspose2d(width, f * mult, 2, stride=2))
            setattr(self, f'multiresblock{i + 6}',
                    Multiresblock(2 * f * mult, f * mult))
            width = d(f * mult)
        self.conv_final = Conv2dBN(width, nclasses, 1, activation='None')

    def forward(self, x, generator=None):
        skips = []
        for i in range(len(self._DOWN)):
            x_m = getattr(self, f'multiresblock{i + 1}')(x)
            x = F.max_pool2d(x_m, 2)
            skips.append(getattr(self, f'respath{i + 1}')(x_m))
        x = self.multiresblock5(x)
        for i in range(4):
            up = getattr(self, f'upsample{i + 6}')(x)
            x = getattr(self, f'multiresblock{i + 6}')(
                torch.cat([up, skips[3 - i]], 1))
        out = self.conv_final(x)
        return out if self.nclasses > 1 else torch.sigmoid(out)
