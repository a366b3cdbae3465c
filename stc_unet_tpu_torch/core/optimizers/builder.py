"""Optimizer construction (≙ ``stc_unet_tpu/core/optimizers/builder.py``).

The JAX package builds an optax chain from the reference's optimizer cfg
(``type='SGD'/'Adam'/'AdamW'/'RMSprop'``, lr, momentum, betas, eps,
weight_decay, ``paramwise_cfg``). Those updates are XLA ops, not Pallas
kernels, so the port builds the matching ``torch.optim`` optimizer:

- SGD (momentum, nesterov), Adam and RMSprop take ``weight_decay`` as
  coupled L2, added to the gradient first; AdamW decays decoupled, scaled
  by the lr. That is what both torch.optim and the optax chain do.
- RMSprop is optax 0.2.6 ``scale_by_rms`` (``eps`` inside the root, the
  second moment starting at 0), which ``torch.optim.RMSprop`` is not
  (``eps`` outside the root): the port carries its own :class:`RMSprop`.
- ``paramwise_cfg`` becomes param groups with ``lr_mult`` and
  ``decay_mult`` (mmcv's ``custom_keys``, where the longest matching key
  wins, then ``norm_decay_mult`` for norm layers and ``bias_decay_mult``
  for other biases). A group's ``lr`` is ``lr · lr_mult`` and its
  ``weight_decay`` is ``weight_decay · decay_mult``. Keys match the port's
  parameter names, the reference fork's (``backbone.inc.conv.conv.0``),
  but where a module carries a ``paramwise_name``, the JAX module's name
  for it: the ViT's LayerNorms are the fork's ``ln1``/``ln2`` and JAX's
  ``norm1``/``norm2``/``norm1_final``, so a ``'norm'`` key takes their
  decay off, as in JAX (mmseg's fork decays them).

``engine.make_train_step`` sets each group's lr to ``schedule(k) ·
lr_mult`` before each step.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

_NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)


class RMSprop(torch.optim.Optimizer):
    """optax ``scale_by_rms`` followed by the lr:
    ``nu = alpha·nu + (1 - alpha)·g²`` from ``nu = 0``, then
    ``p -= lr · g / sqrt(nu + eps)``; ``weight_decay`` adds ``wd·p`` to g
    first."""

    def __init__(self, params, lr=1e-2, alpha=0.99, eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            alpha, eps, wd = group['alpha'], group['eps'], \
                group['weight_decay']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                nu = state['nu']
                nu.mul_(alpha).add_((1 - alpha) * g * g)
                p.sub_(group['lr'] * g * torch.rsqrt(nu + eps))
        return loss


def _param_groups(model: nn.Module, paramwise_cfg: dict) -> List[Dict]:
    """Parameters grouped by their (lr_mult, decay_mult), in model order."""
    custom_keys = paramwise_cfg.get('custom_keys', {})
    sorted_keys = sorted(custom_keys, key=len, reverse=True)
    norm_decay_mult = paramwise_cfg.get('norm_decay_mult', 1.0)
    bias_decay_mult = paramwise_cfg.get('bias_decay_mult', 1.0)
    groups: Dict[tuple, List[nn.Parameter]] = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            name = f'{mname}.{pname}' if mname else pname
            alias = getattr(module, 'paramwise_name', None)
            if alias is not None:
                # the JAX module's name where the fork's differs (the ViT's
                # LayerNorms), which JAX's substring match sees
                name = '.'.join(mname.split('.')[:-1] + [alias, pname])
            lr_mult, decay_mult = 1.0, 1.0
            key = next((k for k in sorted_keys if k in name), None)
            if key is not None:
                lr_mult = custom_keys[key].get('lr_mult', 1.0)
                decay_mult = custom_keys[key].get('decay_mult', 1.0)
            elif isinstance(module, _NORMS):
                decay_mult = norm_decay_mult
            elif pname == 'bias':
                decay_mult = bias_decay_mult
            groups.setdefault((lr_mult, decay_mult), []).append(p)
    return [dict(params=ps, lr_mult=lm, decay_mult=dm)
            for (lm, dm), ps in groups.items()]


def build_optimizer(model: nn.Module, cfg: dict) -> torch.optim.Optimizer:
    """The ``torch.optim`` optimizer of an mmcv-style cfg, e.g.
    ``dict(type='Adam', lr=1e-5, betas=(0.9, 0.999))``, over ``model``'s
    trainable parameters. Every group carries ``lr_mult`` and
    ``decay_mult`` (1.0 without ``paramwise_cfg``)."""
    cfg = dict(cfg)
    constructor = cfg.pop('constructor', 'DefaultOptimizerConstructor')
    if constructor in ('LearningRateDecayOptimizerConstructor',
                       'LayerDecayOptimizerConstructor'):
        raise NotImplementedError(
            f'{constructor} is not ported yet (ROADMAP.md §1, Slice E item '
            f'20)')
    if constructor != 'DefaultOptimizerConstructor':
        raise NotImplementedError(
            f'optimizer constructor {constructor} not supported yet')
    paramwise_cfg = cfg.pop('paramwise_cfg', None) or {}
    opt_type = cfg.pop('type')
    base_lr = cfg.pop('lr')
    wd = cfg.pop('weight_decay', 0.0)
    groups = _param_groups(model, paramwise_cfg)
    for g in groups:
        g['lr'] = base_lr * g['lr_mult']
        g['weight_decay'] = wd * g['decay_mult']
    if opt_type == 'SGD':
        momentum = cfg.get('momentum', 0.0)
        return torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                               nesterov=bool(momentum and
                                             cfg.get('nesterov', False)))
    if opt_type in ('Adam', 'AdamW'):
        klass = torch.optim.Adam if opt_type == 'Adam' else torch.optim.AdamW
        return klass(groups, lr=base_lr,
                     betas=tuple(cfg.get('betas', (0.9, 0.999))),
                     eps=cfg.get('eps', 1e-8))
    if opt_type == 'RMSprop':
        return RMSprop(groups, lr=base_lr, alpha=cfg.get('alpha', 0.99),
                       eps=cfg.get('eps', 1e-8))
    raise KeyError(f'Unsupported optimizer type: {opt_type}')
