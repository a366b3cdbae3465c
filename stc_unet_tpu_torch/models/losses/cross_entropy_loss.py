"""Cross-entropy losses (≙ ``stc_unet_tpu/models/losses/cross_entropy_loss.py``).

Class axis last: pred (N, ..., C), label int (N, ...). The elementwise
loss is zero at ignored pixels and is then reduced by
:func:`weight_reduce_loss`, so the default mean divides by ALL pixels;
``avg_non_ignore=True`` divides by the non-ignored count instead. This is
not ``F.cross_entropy(ignore_index=...)``, whose mean divides by the
valid count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..builder import LOSSES
from .utils import get_class_weight, weight_reduce_loss


def cross_entropy(pred, label, weight=None, class_weight=None,
                  reduction='mean', avg_factor=None, ignore_index=-100,
                  avg_non_ignore=False):
    """Softmax cross entropy over the last axis."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(pred.float(), -1)
    loss = -logp.gather(-1, safe[..., None])[..., 0]
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=loss.device)
        loss = loss * cw[safe]
    loss = torch.where(valid, loss, 0.0)
    if avg_factor is None and avg_non_ignore and reduction == 'mean':
        avg_factor = valid.sum()
    if weight is not None:
        weight = weight.float()
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy(pred, label, weight=None, reduction='mean',
                         avg_factor=None, class_weight=None,
                         ignore_index=-100, avg_non_ignore=False, **kwargs):
    """Sigmoid BCE with logits. pred (N, ..., C) or (N, ..., 1); label int
    (N, ...), one-hot expanded with the ignored pixels masked, or float of
    pred's shape."""
    pred = pred.float()
    if pred.shape[-1] == 1:
        pred = pred[..., 0]
    if pred.ndim != label.ndim:
        num_classes = pred.shape[-1]
        valid = (label >= 0) & (label != ignore_index)
        safe = torch.where(valid, label, 0).long()
        onehot = F.one_hot(safe, num_classes).float() * valid[..., None]
        if weight is None:
            weight = valid[..., None].float()
        else:
            weight = weight[..., None] * valid[..., None]
        label = onehot
        valid_mask = valid[..., None].expand(pred.shape)
    else:
        valid_mask = (label >= 0) & (label != ignore_index)
        if weight is not None:
            weight = weight * valid_mask
        else:
            weight = valid_mask.float()
        label = label.float()
    if reduction == 'mean' and avg_factor is None and avg_non_ignore:
        avg_factor = valid_mask.sum()
    logp = F.logsigmoid(pred)
    lognp = F.logsigmoid(-pred)
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32,
                             device=pred.device)
        loss = -(cw * label * logp + (1 - label) * lognp)
    else:
        loss = -(label * logp + (1 - label) * lognp)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def mask_cross_entropy(pred, target, label, reduction='mean',
                       avg_factor=None, class_weight=None, ignore_index=None,
                       **kwargs):
    """Per-ROI mask BCE: each ROI's class-``label`` channel of pred
    (N, H, W, C) or (N, C) against ``target``; a length-1 tensor."""
    assert ignore_index is None, 'BCE loss does not support ignore_index'
    assert reduction == 'mean' and avg_factor is None
    pred = pred.float()
    label = torch.as_tensor(label, device=pred.device).long()
    pred_slice = pred.gather(
        -1, label.reshape(label.shape[0], *([1] * (pred.ndim - 1))).expand(
            *pred.shape[:-1], 1))[..., 0]
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    loss = torch.clamp(pred_slice, min=0) - pred_slice * target + \
        torch.log1p(torch.exp(-pred_slice.abs()))
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=torch.float32,
                                      device=pred.device)
    return loss.mean()[None]


@LOSSES.register_module()
class CrossEntropyLoss:
    """CE / BCE / mask-BCE loss; ``loss_name`` keys the loss dict."""

    def __init__(self, use_sigmoid=False, use_mask=False, reduction='mean',
                 class_weight=None, loss_weight=1.0, loss_name='loss_ce',
                 avg_non_ignore=False):
        assert (use_sigmoid is False) or (use_mask is False)
        self.use_sigmoid = use_sigmoid
        self.use_mask = use_mask
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.class_weight = get_class_weight(class_weight)
        self.avg_non_ignore = avg_non_ignore
        if self.use_sigmoid:
            self.cls_criterion = binary_cross_entropy
        elif self.use_mask:
            self.cls_criterion = mask_cross_entropy
        else:
            self.cls_criterion = cross_entropy
        self._loss_name = loss_name

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=-100, **kwargs):
        assert reduction_override in (None, 'none', 'mean', 'sum')
        reduction = reduction_override if reduction_override else \
            self.reduction
        return self.loss_weight * self.cls_criterion(
            cls_score, label, weight, class_weight=self.class_weight,
            reduction=reduction, avg_factor=avg_factor,
            avg_non_ignore=self.avg_non_ignore, ignore_index=ignore_index,
            **kwargs)

    @property
    def loss_name(self):
        return self._loss_name
