"""The port's optimizers and lr schedules (``stc_unet_tpu_torch/core``)
against the JAX package's optax chains, on the CPU.

Schedules are compared step by step; the JAX ones compute in f32 and the
port's in Python floats; the f32 rounding of cos and pow leaves a few
1e-6 of relative difference, so they agree to rtol 1e-5. Optimizers take the
same fixed gradients (numpy, from a seed) for a few steps on a small
model; the JAX side runs ``build_optimizer_tx`` on a pytree whose paths
carry the same names. The updates are the same elementwise f32 formulas in
another order, so parameters agree to rtol 1e-5 / atol 1e-7 (their values
are of order 1 and each step moves them by about lr).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from stc_unet_tpu.core.optimizers.builder import build_optimizer_tx
from stc_unet_tpu.core.optimizers.lr_schedules import \
    build_lr_schedule as jax_schedule
from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.core.optimizers import RMSprop
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

MAX_ITERS = 20


@pytest.mark.parametrize('lr_config', [
    None,
    dict(policy='fixed'),
    dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False),
    dict(policy='poly', power=1.0, by_epoch=True),
    dict(policy='step', step=6, gamma=0.5, by_epoch=False),
    dict(policy='step', step=[3, 9, 15], by_epoch=False),
    dict(policy='step', step=2, by_epoch=True),
    dict(policy='CosineAnnealing', min_lr=1e-4, by_epoch=False),
    dict(policy='CosineAnnealing', min_lr_ratio=0.05, by_epoch=True),
    dict(policy='linear', min_lr=2e-4, by_epoch=False),
    dict(policy='poly', power=0.9, by_epoch=False, warmup='linear',
         warmup_iters=5, warmup_ratio=0.1),
    dict(policy='poly', power=0.9, by_epoch=False, warmup='constant',
         warmup_iters=4, warmup_ratio=0.25),
    dict(policy='CosineAnnealing', min_lr=0.0, by_epoch=False, warmup='exp',
         warmup_iters=6, warmup_ratio=0.01),
    dict(policy='step', step=[8], by_epoch=True, warmup='linear',
         warmup_iters=3, warmup_by_epoch=False),
])
def test_lr_schedule_matches_jax(lr_config):
    """Every policy and warmup; ``by_epoch=True`` quantises progress to
    epochs of 3 iterations."""
    base_lr = 1e-2
    ours = build_lr_schedule(lr_config, base_lr, MAX_ITERS, iters_per_epoch=3)
    ref = jax_schedule(lr_config, base_lr, MAX_ITERS, iters_per_epoch=3)
    got = [ours(k) for k in range(MAX_ITERS + 3)]
    want = [float(ref(k)) for k in range(MAX_ITERS + 3)]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_lr_schedule_rejects_unknown_policy_and_warmup():
    with pytest.raises(KeyError):
        build_lr_schedule(dict(policy='cyclic'), 1e-2, 10)
    with pytest.raises(KeyError):
        build_lr_schedule(dict(policy='fixed', warmup='cosine',
                               warmup_iters=2), 1e-2, 10)


# -- optimizers -------------------------------------------------------------

class _Toy(nn.Module):
    """Parameters named as the JAX tree below: a conv, a norm (bn*) and a
    head, with weights and biases."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.conv = nn.Conv2d(3, 4, 3)
        self.backbone.bn = nn.BatchNorm2d(4)
        self.head = nn.Linear(4, 2)


def _toy(seed=0):
    """The torch model and its JAX param tree (same values, same names but
    ``kernel``/``scale`` for torch's ``weight``)."""
    rng = np.random.RandomState(seed)
    model = _Toy()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    tree = {'backbone': {'conv': {'kernel': sd['backbone.conv.weight'],
                                  'bias': sd['backbone.conv.bias']},
                         'bn': {'scale': sd['backbone.bn.weight'],
                                'bias': sd['backbone.bn.bias']}},
            'head': {'kernel': sd['head.weight'], 'bias': sd['head.bias']}}
    pairs = [('backbone.conv.weight', ('backbone', 'conv', 'kernel')),
             ('backbone.conv.bias', ('backbone', 'conv', 'bias')),
             ('backbone.bn.weight', ('backbone', 'bn', 'scale')),
             ('backbone.bn.bias', ('backbone', 'bn', 'bias')),
             ('head.weight', ('head', 'kernel')),
             ('head.bias', ('head', 'bias'))]
    return model, tree, pairs


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _run_both(cfg, steps=4, lr_config=None, seed=0):
    """``steps`` updates with the same gradients on both sides; returns the
    two final parameter sets as {torch name: numpy}."""
    model, tree, pairs = _toy(seed)
    params = {n: p for n, p in model.named_parameters()}
    opt = build_optimizer(model, cfg)
    schedule = build_lr_schedule(lr_config, cfg['lr'], steps + 1)
    tx = build_optimizer_tx(cfg, schedule=jax_schedule(lr_config, cfg['lr'],
                                                       steps + 1),
                            params=tree)
    jparams = tree
    state = tx.init(jparams)
    rng = np.random.RandomState(seed + 1)
    for k in range(steps):
        grads = {name: rng.randn(*params[name].shape).astype(np.float32)
                 for name, _ in pairs}
        for name, _ in pairs:
            params[name].grad = torch.from_numpy(grads[name])
        # as engine.make_train_step sets it
        for group in opt.param_groups:
            group['lr'] = schedule(k) * group['lr_mult']
        opt.step()
        gtree = {'backbone': {'conv': {}, 'bn': {}}, 'head': {}}
        for name, path in pairs:
            _get(gtree, path[:-1])[path[-1]] = jnp.asarray(grads[name])
        updates, state = tx.update(gtree, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    ours = {name: params[name].detach().numpy() for name, _ in pairs}
    ref = {name: np.asarray(_get(jparams, path)) for name, path in pairs}
    return ours, ref


def _assert_params_close(ours, ref):
    for name in ref:
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize('cfg', [
    dict(type='SGD', lr=0.05),
    dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-3),
    dict(type='SGD', lr=0.05, momentum=0.9, nesterov=True,
         weight_decay=1e-3),
    dict(type='Adam', lr=1e-2, betas=(0.9, 0.999)),
    dict(type='Adam', lr=1e-2, betas=(0.8, 0.99), eps=1e-6,
         weight_decay=1e-2),
    dict(type='AdamW', lr=1e-2, weight_decay=0.05),
    dict(type='RMSprop', lr=1e-2),
    dict(type='RMSprop', lr=1e-2, alpha=0.9, eps=1e-4, weight_decay=1e-2),
])
def test_optimizer_matches_jax(cfg):
    """Each type over 4 steps of fixed gradients, under a poly schedule:
    coupled L2 for SGD/Adam/RMSprop, decoupled decay for AdamW."""
    ours, ref = _run_both(cfg, lr_config=dict(policy='poly', power=0.9,
                                              by_epoch=False))
    _assert_params_close(ours, ref)


@pytest.mark.parametrize('opt_type', ['SGD', 'Adam', 'AdamW'])
def test_paramwise_cfg_matches_jax(opt_type):
    """custom_keys (the longest key wins), norm_decay_mult and
    bias_decay_mult, as param groups with lr_mult and decay_mult."""
    cfg = dict(type=opt_type, lr=1e-2, weight_decay=0.1,
               paramwise_cfg=dict(
                   custom_keys={'head': dict(lr_mult=0.1),
                                'head.bias': dict(lr_mult=2.0,
                                                  decay_mult=0.5),
                                'backbone.conv': dict(decay_mult=0.0)},
                   norm_decay_mult=0.0, bias_decay_mult=3.0))
    if opt_type == 'SGD':
        cfg['momentum'] = 0.9
    ours, ref = _run_both(cfg)
    _assert_params_close(ours, ref)
    model, _, _ = _toy()
    groups = {(g['lr_mult'], g['decay_mult']): len(g['params'])
              for g in build_optimizer(model, cfg).param_groups}
    # conv weight and bias (decay 0), bn weight and bias (norm), head
    # weight (lr 0.1), head bias (its own, longer key)
    assert groups == {(1.0, 0.0): 4, (0.1, 1.0): 1, (2.0, 0.5): 1}


def test_rmsprop_is_optax_scale_by_rms():
    """eps inside the root and the second moment from 0: one step of
    gradient g moves p by lr·g/sqrt((1-alpha)·g² + eps), which
    ``torch.optim.RMSprop`` (eps outside the root) does not."""
    p = torch.nn.Parameter(torch.tensor([0.0, 0.0, 0.0]))
    g = torch.tensor([1e-3, 0.5, -2.0])
    opt = RMSprop([p], lr=0.1, alpha=0.9, eps=1e-4)
    p.grad = g.clone()
    opt.step()
    want = -0.1 * g / torch.sqrt(0.1 * g * g + 1e-4)
    torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)
    q = torch.nn.Parameter(torch.zeros(3))
    torch_opt = torch.optim.RMSprop([q], lr=0.1, alpha=0.9, eps=1e-4)
    q.grad = g.clone()
    torch_opt.step()
    assert not torch.allclose(q.detach(), want, rtol=1e-3, atol=0)


def test_build_optimizer_rejects_what_is_not_ported():
    model, _, _ = _toy()
    for constructor in ('LearningRateDecayOptimizerConstructor',
                        'LayerDecayOptimizerConstructor'):
        with pytest.raises(NotImplementedError, match='Slice E'):
            build_optimizer(model, dict(type='AdamW', lr=1e-3,
                                        constructor=constructor))
    with pytest.raises(KeyError):
        build_optimizer(model, dict(type='Lion', lr=1e-3))
    opt = build_optimizer(model, dict(type='Adam', lr=1e-3))
    assert isinstance(opt, torch.optim.Adam)
    assert [(g['lr'], g['lr_mult'], g['decay_mult'])
            for g in opt.param_groups] == [(1e-3, 1.0, 1.0)]
