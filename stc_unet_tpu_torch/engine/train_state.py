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

With a data ``mesh`` of more than one rank (one process a card,
``utils/util_distribution.py``) each rank takes its rows of the global
batch, and the step is the JAX mesh step's: the model's ``BatchNorm``
layers take the global batch's moments, the gradients are averaged over
the ranks by one coalesced all-reduce between ``backward()`` and the
optimizer step (the global loss is the mean of the ranks' losses, as
every rank holds as many images), and the log vars are global means.
The parameters and buffers are broadcast from rank 0 when the step is
made; from then on every rank applies the same update to them and to
its optimizer state.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from stc_unet_tpu_torch.models.bricks import BatchNorm
from stc_unet_tpu_torch.models.losses.utils import total_loss_from_dict
from stc_unet_tpu_torch.models.remat import checkpoint
from stc_unet_tpu_torch.utils.util_distribution import (broadcast_tensors,
                                                        mesh_group)

__all__ = ['make_train_step', 'make_val_step', 'total_loss_from_dict']


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Optional[Callable[[int], float]] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    mesh=None, remat: bool = False) -> Callable:
    """``step(img, gt, generator=None) -> log_vars`` for a segmentor.

    ``img`` is an NHWC batch, ``gt`` its labels (N, H, W); ``generator``
    (a ``torch.Generator`` on the model's device) draws the dropout masks.
    Each call puts the model in train mode. Without ``schedule`` the
    groups keep their lr. ``mesh`` (a ``('data',)`` device mesh or a
    process group) makes it the data-parallel step of the module's
    docstring; a mesh of one rank changes nothing. ``remat``
    rematerialises the whole ``compute_losses`` call in the backward, as
    the JAX step's ``jax.checkpoint(loss_fn)`` does
    (``models/remat.py``: the BN running stats, the generator's draws and
    the log vars are those of the step without it).
    """
    group = mesh_group(mesh)
    if group is not None:
        broadcast_tensors(list(model.parameters()) + list(model.buffers()),
                          group)
    # train-mode BN takes its moments over the group's global batch (no
    # group: this process's)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    count = 0

    def step(img, gt, generator=None):
        nonlocal count
        model.train()
        img = model._as_input(img)
        if compute_dtype is not None:
            img = img.to(compute_dtype)
        if remat:
            losses = checkpoint(model.compute_losses, img, gt, generator)
        else:
            losses = model.compute_losses(img, gt, generator)
        total, log_vars = total_loss_from_dict(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if group is not None:
            if count == 0:
                model._check_loss_keys_consistent(log_vars)
            _average_gradients(model, group)
            log_vars = _global_means(model, log_vars, gt, group)
        if schedule is not None:
            lr = schedule(count)
            for param_group in optimizer.param_groups:
                param_group['lr'] = lr * param_group.get('lr_mult', 1.0)
        optimizer.step()
        count += 1
        return {k: v.detach() for k, v in log_vars.items()}

    return step


def make_val_step(model, mesh=None) -> Callable:
    """``step(img, gt) -> log_vars``: the losses in eval mode (running BN
    stats, no dropout), without gradients; the model's mode is restored.
    With a ``mesh`` of more than one rank the log vars are the global
    batch's means."""
    group = mesh_group(mesh)

    def step(img, gt):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                _, log_vars = total_loss_from_dict(
                    model.compute_losses(img, gt))
        finally:
            model.train(was_training)
        if group is not None:
            log_vars = _global_means(model, log_vars, gt, group)
        return log_vars

    return step


def _average_gradients(model, group) -> None:
    """Each parameter's gradient replaced by its mean over the ranks, in
    one all-reduce of the gradients packed into one f32 buffer (a missing
    gradient counts as zeros, so every rank sends the same layout)."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def _global_means(model, log_vars, gt, group):
    """The log vars of the global batch from the ranks' own, in one
    all-reduce: a loss is a mean over the pixels (or the images) of a
    rank, and every rank holds as many, so the global one is the ranks'
    mean; an accuracy (``*acc_seg``) is a mean over the labelled pixels,
    so it is weighted by the rank's count of them (labels other than the
    ``ignore_index`` of the head that computed it: ``decode.acc_seg``'s,
    ``aux.acc_seg``'s, ...)."""
    keys = list(log_vars)
    values = torch.stack([log_vars[k].detach().float() for k in keys])
    one = values.new_ones(())
    gt = torch.as_tensor(gt, device=values.device)
    heads = dict(model.loss_heads())
    labelled = {}

    def weight(key):
        if not key.endswith('acc_seg'):
            return one
        ignore = heads.get(key.partition('.')[0],
                           model.decode_head).ignore_index
        if ignore not in labelled:
            labelled[ignore] = (gt != ignore).sum().float()
        return labelled[ignore]

    weights = torch.stack([weight(k) for k in keys])
    sums = torch.cat([values * weights, weights])
    dist.all_reduce(sums, group=group)
    means = sums[:len(keys)] / sums[len(keys):]
    return dict(zip(keys, means.unbind()))
