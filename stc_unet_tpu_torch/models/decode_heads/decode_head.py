"""BaseDecodeHead (≙ ``stc_unet_tpu/models/decode_heads/decode_head.py``).

The out_channels/threshold resolution, the input selection and merging,
the classifier (``Dropout2d`` in training + a 1x1 conv) and the losses
(``loss_by_feat``). Heads take and return NCHW tensors; ``loss_by_feat``
takes NHWC logits, as the JAX function does.
"""
from __future__ import annotations

import warnings
from typing import Any, Optional

import torch
import torch.nn as nn

from stc_unet_tpu_torch.ops import resize
from ..bricks import Conv2d, Dropout2d
from ..builder import build_loss
from ..losses import accuracy


def _default_loss():
    return dict(type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)


def resolve_out_channels(num_classes: int, out_channels: Optional[int],
                         threshold: Optional[float]):
    """The reference's out_channels/threshold resolution."""
    if out_channels is None:
        out_channels = num_classes
    if out_channels != num_classes and out_channels != 1:
        raise ValueError(
            'out_channels should equal num_classes, except binary '
            f'segmentation (out_channels==1, num_classes==2); got '
            f'out_channels={out_channels}, num_classes={num_classes}')
    if out_channels == 1 and threshold is None:
        threshold = 0.3
        warnings.warn('threshold is not defined for binary, defaults to 0.3')
    return out_channels, threshold


class BaseDecodeHead(nn.Module):
    """Base decode head; the ctor args are the reference's."""

    def __init__(self, num_classes: int = 2, in_channels: Any = 64,
                 channels: int = 64, out_channels: Optional[int] = None,
                 threshold: Optional[float] = None,
                 dropout_ratio: float = 0.1, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None, in_index: Any = -1,
                 input_transform: Optional[str] = None,
                 loss_decode: Any = None, ignore_index: int = 255,
                 sampler: Optional[dict] = None, align_corners: bool = False,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        # the reference's _init_inputs contract: with a transform,
        # in_channels and in_index are sequences of one length; without,
        # both are ints
        if input_transform is not None:
            assert input_transform in ('resize_concat', 'multiple_select'), \
                (f"input_transform must be 'resize_concat' or "
                 f"'multiple_select', got {input_transform!r}")
            assert isinstance(in_channels, (list, tuple)), \
                'in_channels must be a list/tuple with input_transform'
            assert isinstance(in_index, (list, tuple)), \
                'in_index must be a list/tuple with input_transform'
            assert len(in_channels) == len(in_index), \
                (f'in_channels ({len(in_channels)}) and in_index '
                 f'({len(in_index)}) must have equal length')
        else:
            assert isinstance(in_channels, int), \
                'in_channels must be an int without input_transform'
            assert isinstance(in_index, int), \
                'in_index must be an int without input_transform'
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.channels = channels
        self.out_channels = out_channels
        self.threshold = threshold
        self.dropout_ratio = dropout_ratio
        self.in_index = in_index
        self.input_transform = input_transform
        self.loss_decode = (_default_loss() if loss_decode is None
                            else loss_decode)
        self.ignore_index = ignore_index
        self.sampler = sampler
        self.align_corners = align_corners

    @property
    def final_out_channels(self) -> int:
        out, _ = resolve_out_channels(self.num_classes, self.out_channels,
                                      self.threshold)
        return out

    @property
    def final_threshold(self) -> Optional[float]:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            _, thr = resolve_out_channels(self.num_classes, self.out_channels,
                                          self.threshold)
        return thr

    def _init_cls_seg(self, in_channels: int):
        """Dropout2d + 1x1 conv classifier over ``in_channels`` features."""
        if self.dropout_ratio > 0:
            self.dropout = Dropout2d(self.dropout_ratio)
        self.conv_seg = Conv2d(in_channels, self.final_out_channels, 1)

    def _transform_inputs(self, inputs):
        """Select or merge the backbone's NCHW feature levels (JAX
        ``decode_head.py:111-127``): ``resize_concat`` resizes the levels
        of ``in_index`` to the first one's size (bilinear) and concatenates
        them on channels; ``multiple_select`` returns them as a list;
        otherwise the level ``in_index``."""
        if self.input_transform == 'resize_concat':
            xs = [inputs[i] for i in self.in_index]
            size = xs[0].shape[2:]
            ups = [resize(x.permute(0, 2, 3, 1), size=size, mode='bilinear',
                          align_corners=self.align_corners,
                          warning=False).permute(0, 3, 1, 2) for x in xs]
            return torch.cat(ups, 1)
        if self.input_transform == 'multiple_select':
            idx = self.in_index
            if isinstance(idx, int):
                idx = [idx]
            return [inputs[i] for i in idx]
        idx = self.in_index
        if not isinstance(idx, int):
            idx = idx[0] if len(idx) == 1 else -1
        return inputs[idx]

    def cls_seg(self, feat, generator=None):
        """Dropout2d (training only; its mask from ``generator``) and the
        classifier."""
        if self.dropout_ratio > 0:
            feat = self.dropout(feat, generator)
        return self.conv_seg(feat)

    # -- losses --------------------------------------------------------------
    def build_losses(self):
        cfg = self.loss_decode
        if isinstance(cfg, dict):
            return [build_loss(dict(cfg))]
        return [build_loss(dict(c)) for c in cfg]

    def loss_by_feat(self, seg_logit, seg_label, seg_weight=None) -> dict:
        """The loss dict from head logits (N, h, w, C) and labels (N, H, W)
        (JAX ``decode_head.py:156-182``): the logits are cast to f32 and
        resized to the label size, entries that share a ``loss_name`` are
        summed, and ``acc_seg`` is added."""
        if self.sampler is not None:
            raise NotImplementedError(
                'pixel samplers (OHEM) are not ported yet (ROADMAP.md, '
                'Slice E)')
        seg_logit = resize(seg_logit.float(), size=seg_label.shape[1:3],
                           mode='bilinear', align_corners=self.align_corners,
                           warning=False)
        loss = {}
        for loss_decode in self.build_losses():
            value = loss_decode(seg_logit, seg_label, weight=seg_weight,
                                ignore_index=self.ignore_index)
            if loss_decode.loss_name not in loss:
                loss[loss_decode.loss_name] = value
            else:
                loss[loss_decode.loss_name] = \
                    loss[loss_decode.loss_name] + value
        loss['acc_seg'] = accuracy(seg_logit, seg_label,
                                   ignore_index=self.ignore_index)
        return loss
