"""Loss reduction helpers (≙ ``stc_unet_tpu/models/losses/utils.py``).

Layouts are NHW(C): the class axis is last, as in the JAX package.
"""
from __future__ import annotations

import functools
import json

import numpy as np

EPS = float(np.finfo(np.float32).eps)


def get_class_weight(class_weight):
    """Class weights from a list, a ``.npy`` or JSON file name, or None."""
    if isinstance(class_weight, str):
        if class_weight.endswith('.npy'):
            class_weight = np.load(class_weight)
        else:
            with open(class_weight) as f:
                class_weight = json.load(f)
    return class_weight


def reduce_loss(loss, reduction):
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'invalid reduction: {reduction}')


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    """Apply an elementwise weight, then reduce. With ``avg_factor`` and
    ``reduction='mean'`` the loss is summed and divided by
    ``avg_factor + eps``."""
    if weight is not None:
        assert weight.ndim == loss.ndim
        if weight.ndim > 1:
            assert weight.shape[-1] == 1 or \
                weight.shape[-1] == loss.shape[-1]
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / (avg_factor + EPS)
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def total_loss_from_dict(losses: dict):
    """``(total, log_vars)``: the sum of every ``*loss*`` entry, and every
    entry's mean plus ``loss``. Non-loss entries (``acc_seg``) are logged
    but take no part in the gradient."""
    log_vars = {}
    for name, value in losses.items():
        if isinstance(value, (list, tuple)):
            log_vars[name] = sum(v.mean() for v in value)
        else:
            log_vars[name] = value.mean()
    total = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = total
    return total, log_vars


def weighted_loss(loss_func):
    """Decorator adding weight/reduction/avg_factor to an elementwise loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', avg_factor=None,
                **kwargs):
        loss = loss_func(pred, target, **kwargs)
        return weight_reduce_loss(loss, weight, reduction, avg_factor)

    return wrapper
