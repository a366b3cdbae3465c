"""FPN neck (≙ ``stc_unet_tpu/models/necks/fpn.py``).

A 1x1 ``lateral_convs.{i}`` on each level of ``[start_level,
end_level)`` (``end_level`` exclusive, -1 for all, as in JAX), the
top-down adds (each lateral plus the one above resized to its size, with
``upsample_cfg``'s mode, nearest by default), a 3x3 ``fpn_convs.{i}`` on
each. Up to ``num_outs`` more levels come from stride-2 max pools of the
last output (kernel 1) or, with ``add_extra_convs``, from stride-2 3x3
convs appended to ``fpn_convs`` as mmseg does (``fpn_convs.{n}`` on,
``n`` the levels used). NCHW; the keys are mmseg's.

Each neck of the package sizes its convs from the backbone's
``feature_channels`` (the JAX modules infer them from their inputs) and
asserts that they are the config's ``in_channels``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch.nn as nn
import torch.nn.functional as F

from ..bricks import ConvModule
from ..builder import NECKS
from ..decode_heads.psp_head import resize_nchw


def check_widths(in_channels, feature_channels):
    """The widths a neck takes: the backbone's ``feature_channels`` where
    the segmentor hands them down, which must be the config's
    ``in_channels``; else ``in_channels``."""
    if feature_channels is not None:
        assert list(feature_channels) == list(in_channels), \
            f'in_channels {list(in_channels)} are not the backbone\'s ' \
            f'widths {list(feature_channels)}'
    return list(in_channels)


@NECKS.register_module()
class FPN(nn.Module):
    """Feature Pyramid Network (JAX ``fpn.py:15``). ``add_extra_convs``
    is False (pools), True (``'on_input'`` with ``extra_convs_on_inputs``,
    else ``'on_output'``), ``'on_input'`` (the first extra conv on the
    last used input), ``'on_lateral'`` or ``'on_output'``; with
    ``relu_before_extra_convs`` every extra conv but the first takes a
    ReLU of its input."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 4,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 extra_convs_on_inputs: bool = False,
                 relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = False,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 upsample_cfg: Optional[dict] = None,
                 feature_channels: Optional[Sequence[int]] = None):
        super().__init__()
        widths = check_widths(in_channels, feature_channels)
        self.num_ins = len(widths)
        end = len(widths) if end_level == -1 else end_level
        self.used = list(range(start_level, end))
        self.num_outs = num_outs
        self.relu_before_extra_convs = relu_before_extra_convs
        self.upsample_cfg = dict(upsample_cfg or dict(mode='nearest'))
        cfg = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.lateral_convs = nn.ModuleList([
            ConvModule(widths[i], out_channels, 1, conv_cfg=conv_cfg,
                       norm_cfg=None if no_norm_on_lateral else norm_cfg,
                       act_cfg=act_cfg) for i in self.used])
        self.fpn_convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, padding=1, **cfg)
            for _ in self.used])
        self.num_levels = len(self.used)
        extra = num_outs - self.num_levels
        self.extra_source = None
        if extra > 0 and add_extra_convs:
            mode = add_extra_convs
            if mode is True:
                mode = 'on_input' if extra_convs_on_inputs else 'on_output'
            if mode not in ('on_input', 'on_lateral', 'on_output'):
                raise NotImplementedError(
                    f'invalid add_extra_convs {add_extra_convs!r}')
            self.extra_source = mode
            for i in range(extra):
                c_in = widths[end - 1] if i == 0 and mode == 'on_input' \
                    else out_channels
                self.fpn_convs.append(ConvModule(
                    c_in, out_channels, 3, stride=2, padding=1, **cfg))
        self.out_channels = [out_channels] * max(num_outs, self.num_levels)

    def forward(self, inputs):
        assert len(inputs) == self.num_ins
        laterals = [conv(inputs[i])
                    for conv, i in zip(self.lateral_convs, self.used)]
        mode = self.upsample_cfg.get('mode', 'nearest')
        align = self.upsample_cfg.get('align_corners', None)
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nchw(
                laterals[i], laterals[i - 1].shape[2:], align, mode)
        n = self.num_levels
        outs = [conv(x) for conv, x in zip(self.fpn_convs[:n], laterals)]
        if self.extra_source is None:
            for _ in range(self.num_outs - n):
                outs.append(F.max_pool2d(outs[-1], 1, stride=2))
            return outs
        src = {'on_input': inputs[self.used[-1]], 'on_lateral': laterals[-1],
               'on_output': outs[-1]}[self.extra_source]
        for i, conv in enumerate(self.fpn_convs[n:]):
            if i > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            src = conv(src)
            outs.append(src)
        return outs
