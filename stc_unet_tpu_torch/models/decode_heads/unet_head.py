"""U-Net decoder head with coordinate attention
(≙ ``stc_unet_tpu/models/decode_heads/unet_head.py``).

NCHW modules in ``channels_last``. torch modules need their input widths,
which the JAX modules infer: the segmentor passes the backbone's feature
widths as ``feature_channels``, and each Up stage takes the width of
``cat([skip, upsampled])``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stc_unet_tpu_torch.ops import coordatt_fused, resize
from ..backbones.unet_backbone import DoubleConv
from ..bricks import BatchNorm, Conv2d, h_swish
from ..builder import HEADS
from .decode_head import BaseDecodeHead


class CoordAtt(nn.Module):
    """Coordinate attention on an NCHW (channels_last) x: the gate added to
    x, ``a_h * a_w + x`` (the fork adds the gate, it does not multiply),
    or, with ``residual=False``, the gate ``a_h * a_w`` itself.

    H- and W-strip means → shared 1x1 conv bottleneck (BN + h_swish) →
    per-axis 1x1 conv + sigmoid → the outer-product gate. The strip sums
    are ``strip_pools`` (K1) in both forms: the CUDA kernel on the card,
    its plain version on the CPU, with the JAX VJP's broadcast for its
    backward. ``residual=True`` is the JAX module's fused branch, used by
    STC-UNet's Up: ``gate_add`` (K2) adds the gate, and its backward is
    ``gate_dots`` (K2b). ``residual=False`` is the JAX module's plain
    branch (``unet_head.py:84-85``), used by CARUnet's blocks, which
    multiply their features by the gate in torch ops; it launches no K2.

    The JAX model takes the fused path only when ``not train``
    (``unet_head.py:62``) and its plain chain, with ``jnp.mean`` strips,
    in training. The port keeps its kernels in training on the card, with
    no switch: the functions are the same (``tests/test_torch_train_step.py``
    and ``tests/test_torch_carunet.py`` hold the train steps to JAX's).
    The default is ``residual=True``, the Up stage's call; JAX's is
    False.
    """

    def __init__(self, inp, oup, reduction=4):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = Conv2d(inp, mip, 1)
        self.bn1 = BatchNorm(mip)
        self.conv_h = Conv2d(mip, oup, 1)
        self.conv_w = Conv2d(mip, oup, 1)

    def forward(self, x, residual: bool = True):
        n, c, h, w = x.shape
        xn = x.permute(0, 2, 3, 1).contiguous()            # NHWC
        sh, sw = coordatt_fused.strip_pools(xn)             # f32 sums
        x_h = (sh / w).to(x.dtype)                          # (N, H, C)
        x_w = (sw / h).to(x.dtype)                          # (N, W, C)
        y = torch.cat([x_h, x_w], 1).transpose(1, 2)[..., None]  # (N,C,H+W,1)
        y = h_swish(self.bn1(self.conv1(y)))
        y_h, y_w = y[:, :, :h], y[:, :, h:].transpose(2, 3)
        a_h = torch.sigmoid(self.conv_h(y_h))               # (N, C, H, 1)
        a_w = torch.sigmoid(self.conv_w(y_w))               # (N, C, 1, W)
        if not residual:
            # (N, H, 1, C) * (N, 1, W, C): the gate NHWC, viewed as NCHW
            gate = a_w.permute(0, 2, 3, 1) * a_h.permute(0, 2, 3, 1)
            return gate.permute(0, 3, 1, 2)
        out = coordatt_fused.gate_add(
            xn, a_h[..., 0].transpose(1, 2).contiguous(),
            a_w[:, :, 0].transpose(1, 2).contiguous())
        return out.permute(0, 3, 1, 2)


class Up(nn.Module):
    """Bilinear ×2 (align_corners=True) + pad to the skip + concat
    [skip, up] (+ CoordAtt) + DoubleConv."""

    def __init__(self, in_ch, out_ch, se=False):
        super().__init__()
        self.se = se
        if se:
            self.ca = CoordAtt(in_ch, in_ch)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1, x2):
        x1 = resize(x1.permute(0, 2, 3, 1), scale_factor=2, mode='bilinear',
                    align_corners=True, warning=False).permute(0, 3, 1, 2)
        diff_y = x2.shape[2] - x1.shape[2]
        diff_x = x2.shape[3] - x1.shape[3]
        if diff_y or diff_x:
            x1 = F.pad(x1, (diff_x // 2, diff_x - diff_x // 2,
                            diff_y // 2, diff_y - diff_y // 2))
        x = torch.cat([x2, x1], 1)
        if self.se:
            x = self.ca(x)
        return self.conv(x)


@HEADS.register_module()
class UnetHead(BaseDecodeHead):
    """U-Net decoder over the 5 encoder scales."""

    def __init__(self, decoder_channel: Sequence[int] = (1024, 512, 256, 128,
                                                         64),
                 se: bool = False,
                 feature_channels: Sequence[int] = (64, 128, 256, 512, 512),
                 **kwargs):
        super().__init__(**kwargs)
        dc, fc = list(decoder_channel), list(feature_channels)
        outs = [dc[0] // 4, dc[1] // 4, dc[2] // 4, dc[4]]
        self.up1 = Up(fc[3] + fc[4], outs[0], se=se)
        self.up2 = Up(fc[2] + outs[0], outs[1], se=se)
        self.up3 = Up(fc[1] + outs[1], outs[2], se=se)
        self.up4 = Up(fc[0] + outs[2], outs[3], se=se)
        self._init_cls_seg(outs[3])

    def forward(self, inputs, generator=None):
        out = self.up1(inputs[4], inputs[3])
        out = self.up2(out, inputs[2])
        out = self.up3(out, inputs[1])
        out = self.up4(out, inputs[0])
        return self.cls_seg(out, generator)
