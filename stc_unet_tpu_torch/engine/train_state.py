"""The train step (≙ ``stc_unet_tpu/engine/train_state.py``).

The JAX package compiles one pure ``(state, batch, rng) -> (state, logs)``
function. Here the model and the ``torch.optim`` optimizer hold the state,
and ``make_train_step`` returns a closure that takes one step in place:

1. cast the image to ``compute_dtype`` (the ≙ of the reference's
   ``@auto_fp16``: activations follow the image's dtype, while parameters,
   BN statistics and losses stay f32);
2. forward in train mode and the losses (the BN running stats update
   here);
3. sum the ``*loss*`` entries (:func:`total_loss_from_dict`) and backward;
4. set each param group's lr to ``schedule(k) · lr_mult``, k being the
   0-based count of steps taken, as optax's ``scale_by_schedule`` counts
   it;
5. the optimizer step.

The log vars come back as 0-dim tensors on the model's device, so a loop of
steps does not wait on the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from stc_unet_tpu_torch.models.losses.utils import total_loss_from_dict

__all__ = ['make_train_step', 'make_val_step', 'total_loss_from_dict']


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    mesh=None, remat: bool = False) -> Callable:
    """``step(img, gt, generator=None) -> log_vars`` for a segmentor.

    ``img`` is an NHWC batch, ``gt`` its labels (N, H, W); ``generator``
    (a ``torch.Generator`` on the model's device) draws the dropout masks.
    Each call puts the model in train mode. Without ``schedule`` the
    groups keep their lr.
    """
    if mesh is not None:
        raise NotImplementedError(
            'multi-GPU training (DDP with SyncBatchNorm) is not ported yet '
            '(ROADMAP.md, Slice C item 14)')
    if remat:
        raise NotImplementedError(
            'remat is not ported yet: under torch.utils.checkpoint the '
            'recomputed forward would update the BN running stats twice '
            '(ROADMAP.md)')
    count = 0

    def step(img, gt, generator=None):
        nonlocal count
        model.train()
        img = model._as_input(img)
        if compute_dtype is not None:
            img = img.to(compute_dtype)
        losses = model.compute_losses(img, gt, generator)
        total, log_vars = total_loss_from_dict(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if schedule is not None:
            lr = schedule(count)
            for group in optimizer.param_groups:
                group['lr'] = lr * group.get('lr_mult', 1.0)
        optimizer.step()
        count += 1
        return {k: v.detach() for k, v in log_vars.items()}

    return step


def make_val_step(model) -> Callable:
    """``step(img, gt) -> log_vars``: the losses in eval mode (running BN
    stats, no dropout), without gradients; the model's mode is restored."""

    def step(img, gt):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, log_vars = total_loss_from_dict(
                    model.compute_losses(img, gt))
        finally:
            model.train(was_training)
        return log_vars

    return step
