"""Pixel accuracy (≙ ``stc_unet_tpu/models/losses/accuracy.py``).

Class axis last: pred (N, ..., C), target (N, ...). Ignored pixels are
masked, not indexed out, as in the JAX package.
"""
from __future__ import annotations

from .utils import EPS


def accuracy(pred, target, topk=1, thresh=None, ignore_index=None):
    """Top-k pixel accuracy in percent, masking ``ignore_index``."""
    assert isinstance(topk, (int, tuple))
    return_single = isinstance(topk, int)
    topks = (topk,) if return_single else topk
    maxk = max(topks)
    assert pred.ndim == target.ndim + 1
    assert pred.shape[0] == target.shape[0]
    assert maxk <= pred.shape[-1]

    if maxk == 1:
        pred_value, pred_label = pred.max(-1, keepdim=True)
    else:
        pred_value, pred_label = pred.topk(maxk, -1)
    correct = pred_label == target[..., None]
    if thresh is not None:
        correct = correct & (pred_value > thresh)
    if ignore_index is not None:
        valid = target != ignore_index
        correct = correct & valid[..., None]
        total = valid.sum() + EPS
    else:
        total = target.numel() + EPS
    res = []
    for k in topks:
        correct_k = correct[..., :k].float().sum() + EPS
        res.append(correct_k * (100.0 / total))
    return res[0] if return_single else res


class Accuracy:
    """Callable wrapper with fixed topk/thresh/ignore_index."""

    def __init__(self, topk=(1,), thresh=None, ignore_index=None):
        self.topk = topk
        self.thresh = thresh
        self.ignore_index = ignore_index

    def __call__(self, pred, target):
        return accuracy(pred, target, self.topk, self.thresh,
                        self.ignore_index)
