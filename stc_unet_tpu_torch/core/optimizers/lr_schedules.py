"""Learning-rate schedules (≙ ``stc_unet_tpu/core/optimizers/lr_schedules.py``).

``build_lr_schedule`` turns an mmcv-style ``lr_config`` into a plain
``schedule(step) -> float`` of the 0-based step count;
``engine.make_train_step`` sets each param group's lr from it before the
optimizer step.

Policies: ``poly`` (``my_config/STC-UNet.py``), ``step`` (an int period or
a list of milestones), ``fixed``, ``CosineAnnealing`` and ``linear``; with
optional ``linear``, ``constant`` or ``exp`` warmup in mmcv's
``warmup_iters``/``warmup_ratio`` semantics. ``by_epoch=True`` quantises
progress to epoch boundaries; the full length still comes from
``max_iters``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional


def build_lr_schedule(lr_config: Optional[dict], base_lr: float,
                      max_iters: int,
                      iters_per_epoch: int = 1) -> Callable[[int], float]:
    """``schedule(step) -> lr`` from an mmcv-style lr_config."""
    if lr_config is None:
        return lambda step: base_lr
    cfg = dict(lr_config)
    policy = cfg.pop('policy', 'fixed')
    by_epoch = cfg.pop('by_epoch', True)
    warmup = cfg.pop('warmup', None)
    warmup_iters = cfg.pop('warmup_iters', 0)
    warmup_ratio = cfg.pop('warmup_ratio', 0.1)
    cfg.pop('warmup_by_epoch', None)

    max_epochs = max(max_iters // max(iters_per_epoch, 1), 1)

    def progress(step):
        """Fraction of training done, in [0, 1]."""
        if by_epoch:
            return min((step // iters_per_epoch) / max_epochs, 1.0)
        return min(step / max(max_iters, 1), 1.0)

    if policy == 'fixed':
        def regular(step):
            return base_lr
    elif policy == 'poly':
        power = cfg.get('power', 1.0)
        min_lr = cfg.get('min_lr', 0.0)

        def regular(step):
            coeff = (1.0 - progress(step)) ** power
            return (base_lr - min_lr) * coeff + min_lr
    elif policy == 'step':
        gamma = cfg.get('gamma', 0.1)
        milestones = cfg.get('step')

        def regular(step):
            unit = (step // iters_per_epoch) if by_epoch else step
            if isinstance(milestones, int):
                return base_lr * gamma ** (unit // milestones)
            return base_lr * gamma ** sum(unit >= m for m in milestones)
    elif policy == 'CosineAnnealing':
        min_lr = cfg.get('min_lr', None)
        if min_lr is None:
            min_lr = base_lr * (cfg.get('min_lr_ratio', None) or 0.0)

        def regular(step):
            cos_out = math.cos(math.pi * progress(step)) + 1.0
            return min_lr + 0.5 * (base_lr - min_lr) * cos_out
    elif policy == 'linear':
        min_lr = cfg.get('min_lr', 0.0)

        def regular(step):
            return base_lr + (min_lr - base_lr) * progress(step)
    else:
        raise KeyError(f'Unsupported lr policy: {policy}')

    if warmup is None or warmup_iters <= 0:
        return regular
    if warmup not in ('linear', 'constant', 'exp'):
        raise KeyError(f'Unsupported warmup type: {warmup}')

    def schedule(step):
        lr = regular(step)
        if step >= warmup_iters:
            return lr
        k = step / warmup_iters
        if warmup == 'linear':
            return lr * (1.0 - (1.0 - k) * (1.0 - warmup_ratio))
        if warmup == 'constant':
            return lr * warmup_ratio
        return lr * warmup_ratio ** (1.0 - k)

    return schedule
