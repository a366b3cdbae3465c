"""DC-UNet head (≙ ``stc_unet_tpu/models/decode_heads/dc_unet_head.py``).

Dual-channel multires U-Net: each ``DCBlock`` runs two cascaded 3x3
chains (receptive fields 3/5/7) plus a 1x1 shortcut, summed then
re-normalized; skips pass through ``ResPath`` chains. The JAX module's
quirks are kept: reflect 'same' padding, BN ``affine=False`` after a relu
or sigmoid conv, the ``int`` truncation of the branch widths, and the tanh
output conv. NCHW in ``channels_last``; torch modules need their input
widths, which the JAX modules infer, so each block is given the width of
what it takes.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..bricks import BatchNorm, Conv2d, ConvTranspose2d, Dropout
from ..builder import HEADS
from ..remat import checkpoint
from .decode_head import BaseDecodeHead

_ACTIVATIONS = {None: nn.Identity, 'relu': nn.ReLU, 'sigmoid': nn.Sigmoid,
                'tanh': nn.Tanh}


class Conv2dSame(Conv2d):
    """Reflection-padded 'same' conv: ``k // 2`` rows and columns before,
    one fewer after for an even k, then a VALID conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias)
        ka = kernel_size // 2
        kb = ka - 1 if kernel_size % 2 == 0 else ka
        self.pads = (ka, kb, ka, kb)       # F.pad: left, right, top, bottom

    def forward(self, x):
        if any(self.pads):
            x = F.pad(x, self.pads, mode='reflect')
        return super().forward(x)


class ConvBn(nn.Sequential):
    """conv2d_bn: a bias-free ``Conv2dSame`` → BN (affine only when the
    activation is neither relu nor sigmoid) → the activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, activation: Optional[str] = 'relu'):
        super().__init__(
            Conv2dSame(in_channels, out_channels, kernel_size, bias=False),
            BatchNorm(out_channels,
                      affine=activation not in ('relu', 'sigmoid')),
            _ACTIVATIONS[activation]())


def _widths(u: float):
    """The three branch widths of a ``DCBlock`` of width ``u``, each
    truncated: ``int(1.67·u·f)`` for f = 0.167, 0.333, 0.5."""
    w = 1.67 * u
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


def dc_out_channel(u: float) -> int:
    """A ``DCBlock``'s output width: its three truncated branch widths."""
    return sum(_widths(u))


class DCBlock(nn.Module):
    """Dual-channel multires block; ``Dropout(0.5)`` on its input only
    with ``use_dropout``."""

    def __init__(self, in_channels: int, u: float,
                 use_dropout: bool = False):
        super().__init__()
        c3, c5, c7 = _widths(u)
        out = c3 + c5 + c7
        self.use_dropout = use_dropout
        if use_dropout:
            self.dropout = Dropout(0.5)
        self.conv2d_bn = ConvBn(in_channels, out, 1, activation=None)
        self.conv3x3 = ConvBn(in_channels, c3, 3)
        self.conv5x5 = ConvBn(c3, c5, 3)
        self.conv7x7 = ConvBn(c5, c7, 3)
        self.bn_1 = BatchNorm(out)
        self.conv3x3_2 = ConvBn(in_channels, c3, 3)
        self.conv5x5_2 = ConvBn(c3, c5, 3)
        self.conv7x7_2 = ConvBn(c5, c7, 3)
        self.bn_1_2 = BatchNorm(out)
        self.bn_2 = BatchNorm(out)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.use_dropout:
            x = self.dropout(x, generator)
        shortcut = self.conv2d_bn(x)
        a3 = self.conv3x3(x)
        a5 = self.conv5x5(a3)
        a7 = self.conv7x7(a5)
        out = self.bn_1(torch.cat([a3, a5, a7], 1))
        b3 = self.conv3x3_2(x)
        b5 = self.conv5x5_2(b3)
        b7 = self.conv7x7_2(b5)
        out2 = self.bn_1_2(torch.cat([b3, b5, b7], 1))
        return self.bn_2(F.relu(shortcut + out + out2))


class ResPathBlock(nn.Module):
    """A 1x1 shortcut and a 3x3 conv, summed, relu, BN."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.conv2d_bn1 = ConvBn(in_channels, filters, 1, activation=None)
        self.conv2d_bn2 = ConvBn(in_channels, filters, 3)
        self.bn = BatchNorm(filters)

    def forward(self, x):
        return self.bn(F.relu(self.conv2d_bn1(x) + self.conv2d_bn2(x)))


class ResPath(nn.Module):
    """A chain of ``length`` ResPathBlocks."""

    def __init__(self, in_channels: int, filters: int, length: int):
        super().__init__()
        self.first_block = ResPathBlock(in_channels, filters)
        self.blocks = nn.ModuleList([ResPathBlock(filters, filters)
                                     for _ in range(length - 1)])

    def forward(self, x):
        x = self.first_block(x)
        for block in self.blocks:
            x = block(x)
        return x


class Deconv2x(nn.Module):
    """ConvTranspose2d(k=2, s=2): (H, W) → (2H, 2W)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.deconv = ConvTranspose2d(in_channels, out_channels, 2, stride=2)

    def forward(self, x):
        return self.deconv(x)


@HEADS.register_module()
class DC_Unet(BaseDecodeHead):
    """Monolithic DC-UNet (config ``my_config/DC-UNet.py``) on the raw
    image, whose channel count the segmentor gives as
    ``feature_channels``. It ends in its tanh ``conv10``, without
    ``cls_seg``.

    ``with_cp`` rematerialises blocks in the backward (JAX
    ``DC_Unet._blk``, ``models/remat.py``): ``True`` every ``DCBlock`` and
    ``ResPath``; ``'hires'`` those at or above quarter resolution, the top
    two encoder scales (``mres_block1``, ``res_path1``, ``mres_block2``,
    ``res_path2``) and the two decoder blocks that match them
    (``mres_block8``, ``mres_block9``). Only in training with gradients;
    in eval, as in JAX, it changes nothing."""

    def __init__(self, nf: int = 32, use_dropout: bool = False,
                 with_cp: Any = False, feature_channels: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.with_cp = with_cp
        d = dc_out_channel
        self.mres_block1 = DCBlock(feature_channels, nf)
        self.res_path1 = ResPath(d(nf), nf, 4)
        self.mres_block2 = DCBlock(d(nf), nf * 2)
        self.res_path2 = ResPath(d(nf * 2), nf * 2, 3)
        self.mres_block3 = DCBlock(d(nf * 2), nf * 4)
        self.res_path3 = ResPath(d(nf * 4), nf * 4, 2)
        self.mres_block4 = DCBlock(d(nf * 4), nf * 8)
        self.res_path4 = ResPath(d(nf * 8), nf * 8, 1)
        self.mres_block5 = DCBlock(d(nf * 8), nf * 16)
        self.deconv1 = Deconv2x(d(nf * 16), nf * 8)
        self.mres_block6 = DCBlock(nf * 16, nf * 8, use_dropout=use_dropout)
        self.deconv2 = Deconv2x(d(nf * 8), nf * 4)
        self.mres_block7 = DCBlock(nf * 8, nf * 4, use_dropout=use_dropout)
        self.deconv3 = Deconv2x(d(nf * 4), nf * 2)
        self.mres_block8 = DCBlock(nf * 4, nf * 2, use_dropout=use_dropout)
        self.deconv4 = Deconv2x(d(nf * 2), nf)
        self.mres_block9 = DCBlock(nf * 2, nf)
        self.conv10 = ConvBn(d(nf), self.final_out_channels, 1,
                             activation='tanh')

    def _blk(self, module, *args, hi: bool = False):
        remat = self.with_cp is True or (self.with_cp == 'hires' and hi)
        if remat and self.training:
            return checkpoint(module, *args)
        return module(*args)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        blk = self._blk
        m1 = blk(self.mres_block1, x, hi=True)
        pool = F.max_pool2d(m1, 2)
        m1 = blk(self.res_path1, m1, hi=True)
        m2 = blk(self.mres_block2, pool, hi=True)
        pool = F.max_pool2d(m2, 2)
        m2 = blk(self.res_path2, m2, hi=True)
        m3 = blk(self.mres_block3, pool)
        pool = F.max_pool2d(m3, 2)
        m3 = blk(self.res_path3, m3)
        m4 = blk(self.mres_block4, pool)
        pool = F.max_pool2d(m4, 2)
        m4 = blk(self.res_path4, m4)
        m = blk(self.mres_block5, pool)
        m = blk(self.mres_block6, torch.cat([self.deconv1(m), m4], 1),
                generator)
        m = blk(self.mres_block7, torch.cat([self.deconv2(m), m3], 1),
                generator)
        m = blk(self.mres_block8, torch.cat([self.deconv3(m), m2], 1),
                generator, hi=True)
        m = blk(self.mres_block9, torch.cat([self.deconv4(m), m1], 1),
                hi=True)
        return self.conv10(m)
