"""Dice loss (≙ ``stc_unet_tpu/models/losses/dice_loss.py``), class axis
last.

The JAX (and mmseg) quirks are kept: the valid mask applies only in the
numerator, and labels are clipped to ``C - 1`` before the one-hot, so an
ignored pixel still counts in the denominator as the last class.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES
from .utils import get_class_weight, weighted_loss


@weighted_loss
def dice_loss(pred, target, valid_mask, smooth=1, exponent=2,
              class_weight=None, ignore_index=255):
    """Mean per-class binary dice. pred (N,...,C) softmaxed; target one-hot."""
    num_classes = pred.shape[-1]
    total_loss = 0
    for i in range(num_classes):
        if i != ignore_index:
            d = binary_dice_loss(pred[..., i], target[..., i],
                                 valid_mask=valid_mask, smooth=smooth,
                                 exponent=exponent, reduction='none')
            if class_weight is not None:
                d = d * class_weight[i]
            total_loss = total_loss + d
    return total_loss / num_classes


@weighted_loss
def binary_dice_loss(pred, target, valid_mask, smooth=1, exponent=2,
                     **kwargs):
    """Per-sample binary dice over the flattened pixels."""
    n = pred.shape[0]
    pred = pred.reshape(n, -1)
    target = target.reshape(n, -1).to(pred.dtype)
    valid_mask = valid_mask.reshape(n, -1).to(pred.dtype)
    num = (pred * target * valid_mask).sum(1) * 2 + smooth
    den = (pred ** exponent + target ** exponent).sum(1) + smooth
    return 1 - num / den


@LOSSES.register_module()
class DiceLoss:
    """V-Net dice loss with mmseg semantics."""

    def __init__(self, smooth=1, exponent=2, reduction='mean',
                 class_weight=None, loss_weight=1.0, ignore_index=255,
                 loss_name='loss_dice', **kwargs):
        self.smooth = smooth
        self.exponent = exponent
        self.reduction = reduction
        self.class_weight = get_class_weight(class_weight)
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index
        self._loss_name = loss_name

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, **kwargs):
        # the per-pixel weight does not apply to a per-sample dice vector;
        # it is ignored, as in the JAX package and mmseg
        assert reduction_override in (None, 'none', 'mean', 'sum')
        reduction = reduction_override if reduction_override else \
            self.reduction
        class_weight = (torch.as_tensor(self.class_weight,
                                        dtype=torch.float32,
                                        device=pred.device)
                        if self.class_weight is not None else None)
        pred = torch.softmax(pred.float(), -1)
        num_classes = pred.shape[-1]
        onehot = F.one_hot(target.clamp(0, num_classes - 1).long(),
                           num_classes).float()
        valid_mask = (target != self.ignore_index).int()
        return self.loss_weight * dice_loss(
            pred, onehot, valid_mask=valid_mask, reduction=reduction,
            avg_factor=avg_factor, smooth=self.smooth,
            exponent=self.exponent, class_weight=class_weight,
            ignore_index=self.ignore_index)

    @property
    def loss_name(self):
        return self._loss_name
