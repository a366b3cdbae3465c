"""Resuming the port from a JAX ``.ckpt`` (``engine.load_opt_state``,
``EpochBasedRunner.resume``) against the JAX package, on the CPU.

The mapped state: the tiny flagship's JAX parameters (drawn with numpy)
take three optax updates from random gradients under each optimizer of
the JAX builder; the chain's state goes through a ``.ckpt`` written by the
JAX package and read by the port. The port's ``torch.optim`` state must
equal optax's ``mu``, ``nu``, ``trace`` and ``count`` after the weights'
transposes, bit for bit, and one more step from it must give optax's next
parameters (rtol 1e-5, atol 1e-7, the tolerance of
``tests/test_torch_optimizers.py``), which a fresh optimizer state does
not.

The run: the JAX ``train_segmentor`` trains the tiny flagship for two
epochs as ``tests/test_torch_train_engine.py`` runs it and saves
``epoch_1.ckpt`` with its optimizer state. The port resumes from it for
epoch 2 and is held to JAX's epoch 2 with that file's bands: losses rtol
1e-5, the lr each step applied rtol 1e-6, every parameter within
2·steps·lr, BN stats rtol/atol 1e-3, the first step's moves to lr/100 and
one ulp of the tensor's largest parameter (not the lr/1000 of a run's
first step, where Adam moves by ±lr exactly) on coordinates whose
gradient is at least 1e-3 of the largest and the
epoch's moves to 0.2·lr on those at least 1e-2 of it. A run resumed from
the same file without its ``opt_state`` (Adam starting afresh) fails
these checks.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from stc_unet_tpu.apis import train_segmentor as jax_train
from stc_unet_tpu.core.optimizers.builder import build_optimizer_tx
from stc_unet_tpu.datasets import build_dataset as jax_dataset
from stc_unet_tpu.engine.checkpoint import load_checkpoint_file as jax_load
from stc_unet_tpu.engine import HOOKS as JHOOKS
from stc_unet_tpu.engine.checkpoint import save_checkpoint as jax_save
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.apis import train_segmentor
from stc_unet_tpu_torch.core import build_optimizer
from stc_unet_tpu_torch.datasets import build_dataset
from stc_unet_tpu_torch.engine import (HOOKS, load_checkpoint_file,
                                       load_opt_state)
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures.torch_port import jax_variables, tiny_config, write_split
# by the name pytest gives the module (its directory is on sys.path), so
# that its hooks are registered once
from test_torch_train_engine import (BATCH, ITERS, LR, SeededJaxDataset,
                                     train_config)
from tests.test_torch_train_step import _assert_moves_close
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

OPTIMIZERS = {
    'sgd_momentum': dict(type='SGD', lr=1e-2, momentum=0.9,
                         weight_decay=1e-4),
    'adam': dict(type='Adam', lr=1e-3, betas=(0.9, 0.999)),
    'adamw': dict(type='AdamW', lr=1e-3, weight_decay=1e-2),
    'rmsprop': dict(type='RMSprop', lr=1e-3, alpha=0.9),
    'adam_paramwise': dict(
        type='Adam', lr=1e-3, weight_decay=1e-4,
        paramwise_cfg=dict(custom_keys={
            'decode_head': dict(lr_mult=0.5, decay_mult=0.0)})),
}
STATE_KEYS = {'SGD': ('trace', 'momentum_buffer'),
              'RMSprop': ('nu', 'nu')}


@pytest.fixture(scope='module')
def tiny():
    cfg = tiny_config(JConfig)
    return jax_variables(jax_build(cfg.model))


def _random_tree(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), tree)


def _port_model(variables):
    model = build_segmentor(tiny_config(Config).model)
    model.load_state_dict(jax_to_torch_state(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    return model


def _port_step(model, opt, grads):
    """One step of the port's optimizer on the JAX-layout ``grads``, each
    group at its lr (no schedule: the cfg's lr times ``lr_mult``)."""
    named = dict(model.named_parameters())
    for k, g in jax_to_torch_state({'params': grads}).items():
        named[k].grad = g
    opt.step()
    return {k: p.detach().clone() for k, p in named.items()}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_mapped_state_equals_optax_and_steps_as_optax(name, tiny, tmp_path):
    cfg = OPTIMIZERS[name]
    params = tiny['params']
    tx = build_optimizer_tx(cfg, params=params)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    state = jax.jit(tx.init)(params)
    for seed in range(3):
        updates, state = update(_random_tree(params, seed), state, params)
        params = apply(params, updates)
    path = str(tmp_path / 'opt.ckpt')
    jax_save(path, {'params': params, 'batch_stats': tiny['batch_stats']},
             opt_state=state, step=3)
    ckpt = load_checkpoint_file(path)
    variables = dict(params=params, batch_stats=tiny['batch_stats'])
    model = _port_model(variables)
    opt = build_optimizer(model, cfg)
    load_opt_state(opt, model, ckpt['opt_state'])

    named = dict(model.named_parameters())
    if cfg['type'] in ('Adam', 'AdamW'):
        adam = next(s for s in state if hasattr(s, 'mu'))
        expected = {'exp_avg': adam.mu, 'exp_avg_sq': adam.nu}
        for k, p in named.items():
            assert float(opt.state[p]['step']) == int(adam.count) == 3
    else:
        jax_field, torch_field = STATE_KEYS[cfg['type']]
        stat = next(s for s in state if hasattr(s, jax_field))
        expected = {torch_field: getattr(stat, jax_field)}
    for torch_field, tree in expected.items():
        want = jax_to_torch_state({'params': jax.tree_util.tree_map(
            np.asarray, tree)})
        assert sorted(want) == sorted(named)
        for k, p in named.items():
            got = opt.state[p][torch_field]
            assert got.dtype == torch.float32 and got.device == p.device
            assert torch.equal(got, want[k]), (torch_field, k)

    grads = _random_tree(params, 7)
    updates, _ = update(grads, state, params)
    want = jax_to_torch_state({'params': jax.tree_util.tree_map(
        np.asarray, apply(params, updates))})
    got = _port_step(model, opt, grads)
    for k in named:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    # a fresh state does not take optax's step
    fresh = _port_model(variables)
    got = _port_step(fresh, build_optimizer(fresh, cfg), grads)
    with pytest.raises(AssertionError):
        for k in named:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_opt_state_of_another_optimizer_or_model_raises(tiny, tmp_path):
    params = tiny['params']
    tx = build_optimizer_tx(OPTIMIZERS['adam'], params=params)
    path = str(tmp_path / 'opt.ckpt')
    jax_save(path, tiny, opt_state=jax.jit(tx.init)(params), step=0)
    opt_state = load_checkpoint_file(path)['opt_state']
    model = _port_model(tiny)
    with pytest.raises(ValueError, match='SGD needs'):
        load_opt_state(build_optimizer(model, OPTIMIZERS['sgd_momentum']),
                       model, opt_state)
    other_cfg = tiny_config(Config)      # other widths, other shapes
    other_cfg.model.backbone.channel_list = [4, 4, 4, 4]
    other = build_segmentor(other_cfg.model)
    with pytest.raises(ValueError, match='does not match'):
        load_opt_state(build_optimizer(other, OPTIMIZERS['adam']), other,
                       opt_state)
    layer_decay = dict(OPTIMIZERS['adam'],
                       constructor='LayerDecayOptimizerConstructor')
    with pytest.raises(NotImplementedError, match='item 20'):
        build_optimizer(model, layer_decay)


# -- a JAX run resumed by the port ---------------------------------------------

@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp('resume')
    write_split(str(base / 'train'), 4, 32, seed=1)
    write_split(str(base / 'val'), 2, 32, seed=2)
    return str(base / 'train'), str(base / 'val'), base


@pytest.fixture(scope='module')
def jax_run(roots):
    """JAX's unbroken 2-epoch run (its record and runner), which saves
    ``epoch_1.ckpt`` with the optimizer state; and a copy of that file
    without ``opt_state``."""
    train_root, val_root, base = roots
    work = str(base / 'jax')
    cfg = train_config(JConfig, train_root, val_root, work)
    cfg.checkpoint_config.save_optimizer = True
    model = jax_build(cfg.model)
    model.variables = jax_variables(model)
    ds = jax_dataset(cfg.data.train)
    model.CLASSES, model.PALETTE = ds.CLASSES, ds.PALETTE
    count = jax.local_device_count
    jax.local_device_count = lambda *a, **k: 1
    try:
        runner = jax_train(model, SeededJaxDataset(ds, 0, ITERS * BATCH),
                           cfg, validate=False)
    finally:
        jax.local_device_count = count
    ckpt = f'{work}/epoch_1.ckpt'
    blob = jax_load(ckpt)
    assert 'opt_state' in blob and blob['step'] == ITERS
    bare = str(base / 'bare.ckpt')
    jax_save(bare, blob['variables'], step=blob['step'], meta=blob['meta'])
    return runner, JHOOKS.get('RecordTrainHook').runs[-1], ckpt, bare


def _resume(roots, work, ckpt):
    train_root, val_root, _ = roots
    cfg = train_config(Config, train_root, val_root, work)
    cfg.resume_from = ckpt
    model = build_segmentor(cfg.model)
    runner = train_segmentor(model, build_dataset(cfg.data.train), cfg,
                             device='cpu')
    return runner, HOOKS.get('RecordTrainHook').runs[-1]


def _check_epoch_2(jrunner, jrec, trunner, trec):
    """The port's epoch 2 against JAX's, in the bands of
    ``tests/test_torch_train_engine.py``; raises AssertionError."""
    assert trunner.epoch == 2 and trunner.iter == 2 * ITERS
    assert len(trec['losses']) == ITERS
    for i, (got, want) in enumerate(zip(trec['losses'],
                                        jrec['losses'][ITERS:])):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f'iteration {ITERS + i} {k}')
    np.testing.assert_allclose([s['lr'] for s in trec['steps']],
                               [s['lr'] for s in jrec['steps'][ITERS:]],
                               rtol=1e-6)
    ref = jax_to_torch_state(jax.tree_util.tree_map(
        np.asarray, jrunner.state.variables))
    sd = trunner.model.state_dict()
    for k, want in ref.items():
        if k.endswith('num_batches_tracked'):
            assert int(sd[k]) == 2 * ITERS, k
        elif k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=0,
                                       atol=2 * 2 * ITERS * LR, err_msg=k)
    start = trec['start']['params']
    jpoints = [s['params'] for s in jrec['steps'][ITERS - 1:]]
    for k, p in start.items():
        assert torch.equal(p, jpoints[0][k]), k
    points = [start] + [s['params'] for s in trec['steps']]

    def moves(a, b):
        return {k: (points[b][k] - points[a][k],
                    jpoints[b][k] - jpoints[a][k]) for k in start}

    g1 = trec['steps'][0]['grads']
    scale = max(g.abs().max().item() for g in g1.values())
    # The first step's band is lr/100 and one f32 ulp of the tensor's
    # largest parameter, not the lr/1000 that holds the first step of a
    # run: there Adam moves each coordinate by ±lr exactly on both sides,
    # while with a history the move follows the gradient's value, which
    # the two packages compute in another order (3 ulps of a 0.1 weight,
    # 2.2e-8, seen), and p + move rounds to one of two floats (1 ulp of a
    # BN scale near 1, 1.2e-7, seen). A fresh state is off by up to lr.
    compared = total = 0
    for k, (move, jmove) in moves(0, 1).items():
        strong = g1[k].abs() >= 1e-3 * scale
        compared, total = compared + int(strong.sum()), total + strong.numel()
        ulp = float(np.spacing(np.float32(start[k].abs().max().item())))
        np.testing.assert_allclose(move[strong].numpy(),
                                   jmove[strong].numpy(), rtol=0,
                                   atol=1e-2 * LR + ulp, err_msg=k)
    assert compared >= total // 4, (compared, total)
    _assert_moves_close(moves(0, ITERS), g1, 1e-2 * scale, atol=0.2 * LR)


def test_port_resumes_a_jax_run_from_its_ckpt(roots, jax_run, tmp_path):
    jrunner, jrec, ckpt, bare = jax_run
    trunner, trec = _resume(roots, str(tmp_path / 'port'), ckpt)
    _check_epoch_2(jrunner, jrec, trunner, trec)
    # without the optimizer state Adam starts afresh: the checks fail
    trunner, trec = _resume(roots, str(tmp_path / 'bare'), bare)
    with pytest.raises(AssertionError):
        _check_epoch_2(jrunner, jrec, trunner, trec)


def test_auto_resume_takes_the_newest_jax_ckpt(roots, jax_run, tmp_path):
    """A work dir holding only the JAX run's ``.ckpt`` files resumes from
    the newest (``epoch_2.ckpt``: nothing left to train)."""
    import shutil
    jrunner, _, ckpt, _ = jax_run
    work = tmp_path / 'auto'
    work.mkdir()
    for n in (1, 2):
        shutil.copy(ckpt.replace('epoch_1', f'epoch_{n}'),
                    work / f'epoch_{n}.ckpt')
    train_root, val_root, _ = roots
    cfg = train_config(Config, train_root, val_root, str(work))
    cfg.auto_resume = True
    cfg.custom_hooks = []
    runner = train_segmentor(build_segmentor(cfg.model),
                             build_dataset(cfg.data.train), cfg,
                             device='cpu')
    assert (runner.epoch, runner.iter) == (2, 2 * ITERS)
    want = jax_to_torch_state(jax.tree_util.tree_map(
        np.asarray, jrunner.state.variables))
    for k, v in runner.model.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(v, want[k]), k
