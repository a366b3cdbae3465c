"""Rematerialised training (``stc_unet_tpu_torch/models/remat.py``) against
the plain step of the port, on the CPU, at tiny widths.

Each mode of the JAX package's remat is held to the same model trained
without it: ``make_train_step(remat=True)`` on STC-UNet, MaxViT-UNet's
``with_cp`` in ``True``, ``'block'``, ``'dots'`` and ``'attn'``, DC-UNet's
``with_cp`` in ``True`` and ``'hires'``. Both runs start from the same
seeded weights and take three Adam steps (poly lr) on one batch, each run
with its own ``torch.Generator`` from the same seed and every dropout,
drop-path and attention-dropout rate above 0, so the masks and K3's seed
come from the generator inside the recomputed regions. After each step
the two must agree: the log vars, every gradient, the BN running stats,
``num_batches_tracked`` (one a step) and the generator's state. On the
CPU the recompute runs the same ops on the same values in the same order,
so the tolerance is zero: bit-equal.

Against JAX: STC-UNet's ``remat=True`` here, three Adam steps against
JAX's ``jax.checkpoint`` step, each from JAX's state, held as
``tests/fixtures/torch_monolithic.py`` holds a step; the MaxViT and
DC-UNet tiers in ``slow`` tests of ``tests/test_torch_maxvit.py`` and
``tests/test_torch_dc_unet.py``, since each compiles a JAX remat step.
"""
import numpy as np
import pytest
import torch

from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.engine import make_train_step
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models import remat
from stc_unet_tpu_torch.models.bricks import BatchNorm
from stc_unet_tpu_torch.models.utils import maxvit_core
from stc_unet_tpu_torch.utils import Config
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import jax_variables, tiny_config
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

LOSSES = [dict(type='CrossEntropyLoss', use_sigmoid=False,
               loss_name='loss_bce', loss_weight=1.0),
          dict(type='DiceLoss', loss_name='loss_dice', loss_weight=1.0)]
OPTIMIZER = dict(type='Adam', lr=1e-3, betas=(0.9, 0.999))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)
STEPS = 3


def stc_cfg(dropout=0.3):
    cfg = tiny_config(Config).to_dict()['model']
    cfg['decode_head']['dropout_ratio'] = dropout
    return cfg


def maxvit_cfg(with_cp=False, rate=0.2):
    """The tiny MaxViT-UNet of ``tests/test_torch_maxvit.py``, ``with_cp``
    in the encoder and the decoder."""
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='MaxViT', in_channels=3, depths=(1, 1, 1, 1),
                      channels=(8, 8, 8, 8), embed_dim=8, num_heads=2,
                      grid_window_size=(2, 2), attn_drop=rate, drop=rate,
                      drop_path=rate, mlp_ratio=2, with_cp=with_cp),
        decode_head=dict(type='MaxViTDecoder', in_channels=[8, 8, 8, 8],
                         output_size=(32, 32), num_heads=2,
                         grid_window_size=(2, 2), depths=(1, 1, 1),
                         channels=8, num_classes=2, mlp_ratio=2.0,
                         attn_drop=rate, drop=rate, drop_path=rate,
                         dropout_ratio=rate, with_cp=with_cp,
                         loss_decode=LOSSES),
        test_cfg=dict(mode='whole'))


def dc_cfg(with_cp=False):
    """DC-UNet at ``nf=4`` (``tests/test_torch_dc_unet.py``) with its
    decoder's ``Dropout(0.5)``."""
    return dict(type='EncoderDecoderFull',
                decode_head=dict(type='DC_Unet', out_channels=2, nf=4,
                                 use_dropout=True, with_cp=with_cp,
                                 norm_cfg=dict(type='BN'),
                                 loss_decode=LOSSES),
                test_cfg=dict(mode='whole'))


# (config, make_train_step's remat, image side)
MODES = {
    'stc-remat': (stc_cfg, True, 32),
    'maxvit-True': (lambda: maxvit_cfg(True), False, 64),
    'maxvit-block': (lambda: maxvit_cfg('block'), False, 64),
    'maxvit-dots': (lambda: maxvit_cfg('dots'), False, 64),
    'maxvit-attn': (lambda: maxvit_cfg('attn'), False, 64),
    'dc-True': (lambda: dc_cfg(True), False, 32),
    'dc-hires': (lambda: dc_cfg('hires'), False, 32),
}
PLAIN = {'stc': stc_cfg, 'maxvit': maxvit_cfg, 'dc': dc_cfg}


def batch(size, n=2, seed=3):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, size, size, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(n, size, size) < 0.1] = 255
    return img, gt


def run(cfg, remat_step, size):
    """Three Adam steps from seed-0 weights: per step the log vars, the
    gradients, the state dict and the generator's state."""
    tm = build_segmentor(cfg).init_weights(0)
    tm = tm.to(memory_format=torch.channels_last)
    step = make_train_step(tm, build_optimizer(tm, OPTIMIZER),
                           build_lr_schedule(LR_CONFIG, 1e-3, 10),
                           remat=remat_step)
    g = torch.Generator().manual_seed(7)
    img, gt = batch(size)
    out = []
    for _ in range(STEPS):
        logs = step(img, gt, g)
        out.append(dict(
            logs={k: v.item() for k, v in logs.items()},
            grads={k: p.grad.clone() for k, p in tm.named_parameters()},
            state={k: v.clone() for k, v in tm.state_dict().items()},
            rng=g.get_state()))
    return out


@pytest.fixture(scope='module')
def plain_runs():
    cache = {}

    def get(model, size):
        if model not in cache:
            cache[model] = run(PLAIN[model](), False, size)
        return cache[model]
    return get


@pytest.mark.parametrize('mode', list(MODES))
def test_remat_steps_equal_the_plain_steps(mode, plain_runs):
    make_cfg, remat_step, size = MODES[mode]
    plain = plain_runs(mode.split('-')[0], size)
    got = run(make_cfg(), remat_step, size)
    for i, (a, b) in enumerate(zip(got, plain)):
        assert a['logs'] == b['logs'], f'step {i}'
        assert sorted(a['grads']) == sorted(b['grads'])
        for k, v in b['grads'].items():
            assert torch.equal(a['grads'][k], v), f'step {i}: grad {k}'
        for k, v in b['state'].items():
            assert torch.equal(a['state'][k], v), f'step {i}: {k}'
            if k.endswith('num_batches_tracked'):
                assert int(v) == i + 1, k
        assert torch.equal(a['rng'], b['rng']), f'step {i}: generator'
    # the steps moved the net and the generator
    assert not torch.equal(got[0]['rng'], got[1]['rng'])


def test_the_recompute_leaves_the_running_stats_and_the_generator():
    """Inside one checkpointed call: the forward updates the BN stats
    once and draws a mask from the generator; the backward's recompute
    draws the same mask again from the state before the forward, and
    leaves the stats and the generator where the forward left them. The
    gradient is the plain call's, and the mask matters to it: another
    draw gives another gradient."""
    bn = BatchNorm(4).train()

    def fn(x, generator):
        y = bn(x)
        keep = torch.rand(y.shape, generator=generator) < 0.5
        return torch.where(keep, y * 2, torch.zeros(()))

    x = torch.randn(2, 4, 3, 3, requires_grad=True)
    weights = torch.arange(x.numel(), dtype=torch.float32).reshape(x.shape)
    g = torch.Generator().manual_seed(0)
    y = remat.checkpoint(fn, x, g)
    after = g.get_state()
    stats = bn.running_mean.clone(), bn.running_var.clone()
    assert int(bn.num_batches_tracked) == 1
    (y * weights).sum().backward()
    assert int(bn.num_batches_tracked) == 1
    assert torch.equal(bn.running_mean, stats[0])
    assert torch.equal(bn.running_var, stats[1])
    assert torch.equal(g.get_state(), after)
    assert not remat.recomputing()
    grads = []
    for seed in (0, 1):
        xs = x.detach().clone().requires_grad_()
        (fn(xs, torch.Generator().manual_seed(seed)) * weights).sum() \
            .backward()
        grads.append(xs.grad)
    assert torch.equal(x.grad, grads[0])
    assert not torch.equal(grads[0], grads[1])


def test_dots_saves_the_matmuls_and_recomputes_the_attention(monkeypatch):
    """``'dots'`` keeps the Linear layers' ``addmm``/``mm`` results and
    recomputes the rest: the attention (K3f on the card; here its plain
    version) runs again in the backward, once a call, as in ``'block'``;
    without remat it runs once. Counted on the CPU by wrapping the
    ``window_attention`` that the MaxViT blocks call."""
    calls = {'n': 0}
    wa = maxvit_core.window_attention

    def counted(*args, **kwargs):
        calls['n'] += 1
        return wa(*args, **kwargs)

    monkeypatch.setattr(maxvit_core, 'window_attention', counted)
    counts = {}
    for with_cp in (False, 'block', 'dots', 'attn'):
        tm = build_segmentor(maxvit_cfg(with_cp)).init_weights(0).train()
        img, gt = batch(64)
        calls['n'] = 0
        losses = tm.compute_losses(img, gt, torch.Generator().manual_seed(0))
        forward = calls['n']
        sum(v for k, v in losses.items() if 'loss' in k).backward()
        counts[with_cp] = (forward, calls['n'] - forward)
    # 7 blocks (4 encoder, 3 decoder) of two attention transformers
    assert counts == {False: (14, 0), 'block': (14, 14), 'dots': (14, 14),
                      'attn': (14, 14)}

    # what 'dots' saves: only the plain matrix products
    saved = []
    policy = remat._dots_policy
    for op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default,
               torch.ops.aten.convolution.default,
               torch.ops.aten.empty.memory_format):
        saved.append(policy(None, op) ==
                     torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE)
    assert saved == [True, True, False, False, False]


def test_with_cp_changes_nothing_in_eval_and_refuses_unknown_modes():
    img = batch(64)[0]
    ref = build_segmentor(maxvit_cfg()).init_weights(0).encode_decode(img)
    for with_cp in (True, 'dots', 'attn'):
        m = build_segmentor(maxvit_cfg(with_cp)).init_weights(0)
        assert torch.equal(m.encode_decode(img), ref)
    block = maxvit_core.MaxViTBlock(4, 4, num_heads=2,
                                    grid_window_size=(2, 2)).train()
    with pytest.raises(ValueError, match="'dots'"):
        maxvit_core.apply_maxvit_block(block, torch.randn(1, 4, 4, 4),
                                       'hires')
    with pytest.raises(ValueError, match='policy'):
        remat.checkpoint(lambda x: x, torch.ones(1), policy='all')
    img32 = batch(32)[0]
    ref = build_segmentor(dc_cfg()).init_weights(0).encode_decode(img32)
    for with_cp in (True, 'hires'):
        m = build_segmentor(dc_cfg(with_cp)).init_weights(0)
        assert torch.equal(m.encode_decode(img32), ref)


def test_stc_remat_steps_match_the_jax_remat_steps():
    """``make_train_step(remat=True)`` against the JAX step with
    ``remat=True`` (``jax.checkpoint`` over the loss) on the tiny
    flagship, dropout off."""
    from stc_unet_tpu.models import build_segmentor as jax_build
    cfg = stc_cfg(dropout=0.0)
    variables = jax_variables(jax_build(cfg))
    img, gt = batch(32)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, variables, img, gt,
                                         remat=True), remat=True)
