"""The port's train step (``stc_unet_tpu_torch/engine``) and the train-mode
modules under it, against the JAX package on the CPU.

Inputs are made with numpy from a seed. The tiny flagship config
(``__graft_entry__._flagship_cfg(tiny=True)``) runs with
``dropout_ratio=0`` on both sides, as ``tools/parity_train.py`` does:
dropout masks cannot match across the two RNGs. Weights come from the JAX
init (random BN running stats) through ``jax_to_torch_state``. The JAX
train step is compiled once per optimizer for the module.

Tolerances, all in f32: the BN brick and the losses agree to rtol 1e-5
(sums in another order); the gradients of the whole net to rtol 1e-3 /
atol 3e-5·max|g| (the convolutions and attention sum in another order and
the backward compounds it, as ``tests/test_torch_stc_unet.py`` allows
1e-4 on the logits); the per-step losses to rtol 1e-5; the BN running
stats and the SGD parameters after 3 steps to rtol 1e-4 / atol 1e-6. Under
Adam, coordinates with near-zero gradient move by ±lr in a direction that
follows noise (``tools/parity_train.py:12-17``), so all parameters are
held only to 2·steps·lr, and the BN stats, which later steps take from
those parameters, to rtol/atol 1e-3. The parameter moves are held tightly
where the first gradient is well above its noise: lr/1000 after step 1,
0.2·lr after 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from stc_unet_tpu.core import build_lr_schedule as jax_schedule
from stc_unet_tpu.core import build_optimizer_tx
from stc_unet_tpu.engine import TrainState
from stc_unet_tpu.engine import make_train_step as jax_train_step
from stc_unet_tpu.engine import total_loss_from_dict as jax_total
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.backbones.unet_backbone import \
    MultiheadAttention as JMHA
from stc_unet_tpu.models.bricks import BatchNorm as JBN
from stc_unet_tpu.models.segmentors.base import BaseSegmentor as JBase
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.engine import (make_train_step, make_val_step,
                                       total_loss_from_dict)
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.backbones.unet_backbone import \
    MultiheadAttention
from stc_unet_tpu_torch.models.bricks import BatchNorm, Dropout2d
from stc_unet_tpu_torch.models.segmentors.base import BaseSegmentor
from stc_unet_tpu_torch.utils import jax_to_torch_state
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

STEPS = 3
ADAM_LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- BatchNorm and Dropout2d in train mode ----------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batchnorm_train_matches_jax(dtype):
    """Batch statistics in f32 over (N, H, W), the biased variance to
    normalise, the unbiased one into running_var at momentum 0.1; the
    gradient flows through the statistics. In bf16 the output is the same
    f32 value cast once, so it agrees to one bf16 ulp (rtol 2^-7)."""
    rng = np.random.RandomState(0)
    n, h, w, c = 3, 5, 4, 6
    x = (rng.randn(n, h, w, c) * 2 + 1).astype(np.float32)
    scale, bias = rng.rand(c).astype(np.float32) + 0.5, \
        rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32) * 0.1, \
        rng.rand(c).astype(np.float32) + 0.5
    do = rng.randn(n, h, w, c).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    def jfwd(x_, s_, b_):
        return JBN().apply({'params': {'scale': s_, 'bias': b_},
                            'batch_stats': {'mean': mean, 'var': var}},
                           x_, train=True, mutable=['batch_stats'])

    args = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    jy, jstats = jfwd(*args)
    _, vjp = jax.vjp(lambda *a: jfwd(*a)[0], *args)
    jdx, jds, jdb = vjp(jnp.asarray(do, jdt))

    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(do).to(tdt).permute(0, 3, 1, 2))
    assert y.dtype == tdt and int(bn.num_batches_tracked) == 1
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == 'float32'
           else dict(rtol=2 ** -7, atol=2 ** -7))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).float().detach().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jstats['batch_stats']['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jstats['batch_stats']['var']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        xt.grad.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(jdx, np.float32), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jds),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdb),
                               rtol=1e-4, atol=1e-4)


def test_batchnorm_eval_leaves_the_running_stats():
    bn = BatchNorm(4).eval()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    before = [bn.running_mean.clone(), bn.running_var.clone()]
    torch.testing.assert_close(bn(x), x / torch.sqrt(torch.tensor(1 + 1e-5)))
    assert torch.equal(bn.running_mean, before[0]) and \
        torch.equal(bn.running_var, before[1]) and \
        int(bn.num_batches_tracked) == 0


def test_dropout2d_one_mask_per_channel_from_the_generator():
    """One keep mask per (n, c), kept channels scaled by 1/(1-p); one
    generator seed gives one mask; the identity in eval and at p=0."""
    p = 0.1
    drop = Dropout2d(p).train()
    x = torch.ones(64, 128, 3, 2)
    y = drop(x, torch.Generator().manual_seed(7))
    per_channel = y[:, :, 0, 0]
    assert torch.equal(y, per_channel[:, :, None, None].expand_as(y))
    assert set(per_channel.unique().tolist()) == {
        0.0, torch.tensor(1 / (1 - p)).item()}
    keep = (per_channel > 0).float().mean().item()
    # 8192 channels: the keep rate's std is sqrt(0.09 / 8192) = 3.3e-3
    assert abs(keep - (1 - p)) < 0.02, keep
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(7)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(8)))
    assert drop.eval()(x) is x
    assert Dropout2d(0.0).train()(x) is x


# -- MHA dtype flow -----------------------------------------------------------

@pytest.mark.parametrize('train', [False, True])
def test_mha_dtype_flow_matches_jax(train):
    """A bf16 input: in training the in_proj is cast to bf16 and the output
    stays bf16; in eval it stays f32 and the output promotes to f32."""
    rng = np.random.RandomState(1)
    c, heads, n, length = 8, 2, 2, 5
    q, k, v = (rng.randn(n, length, c).astype(np.float32) for _ in range(3))
    jm = JMHA(embed_dim=c, num_heads=heads)
    jv = _np(jm.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in
                                              (q, k, v))))
    jout = jm.apply(jv, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    train=train)
    tm = MultiheadAttention(c, heads).train(train)
    p = jv['params']
    with torch.no_grad():
        tm.in_proj_weight.copy_(torch.tensor(p['in_proj_weight']))
        tm.in_proj_bias.copy_(torch.tensor(p['in_proj_bias']))
        tm.out_proj.weight.copy_(torch.tensor(
            p['out_proj']['linear']['kernel'].T))
        tm.out_proj.bias.copy_(torch.tensor(p['out_proj']['linear']['bias']))
    tout = tm(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = 'bfloat16' if train else 'float32'
    assert str(jout.dtype) == want and tout.dtype == getattr(torch, want)
    # bf16 matmuls accumulate in another order: a few bf16 ulps
    np.testing.assert_allclose(tout.float().detach().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=2 ** -5, atol=2 ** -5)


def test_train_mode_keeps_a_bf16_image_in_bf16():
    """The whole model: in training x4, x5 and the decoder stay bf16; the
    losses are f32."""
    cfg = _flagship_cfg(tiny=True)
    cfg['decode_head']['dropout_ratio'] = 0.0
    tm = build_segmentor(cfg).init_weights().to(
        memory_format=torch.channels_last).train()
    img = torch.rand(1, 32, 32, 3,
                     generator=torch.Generator().manual_seed(0)).bfloat16()
    feats = tm.backbone(img.permute(0, 3, 1, 2))
    assert [f.dtype for f in feats] == [torch.bfloat16] * 5
    assert tm.decode_head(feats).dtype == torch.bfloat16
    losses = tm.compute_losses(img, torch.zeros(1, 32, 32, dtype=torch.long))
    assert all(v.dtype == torch.float32 for v in losses.values())
    tm.eval()
    with torch.no_grad():
        feats = tm.backbone(img.permute(0, 3, 1, 2))
    assert [f.dtype for f in feats] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2


# -- the train step against JAX's -------------------------------------------

def _jax_variables(jm, seed=0, size=32):
    """The JAX init (jitted: one compile), with BN running stats drawn at
    random so their update is visible."""
    init = jax.jit(lambda rng, x: jm.net.init(
        {'params': rng, 'dropout': rng}, x, train=False,
        method=EncoderDecoderNet.forward_heads))
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)

    def stats(tree):
        return {k: stats(t) if hasattr(t, 'items') else (
            rng.uniform(-0.2, 0.2, t.shape) if k == 'mean'
            else rng.uniform(0.8, 1.2, t.shape)).astype(np.float32)
            for k, t in tree.items()}

    return {'params': _np(dict(v['params'])),
            'batch_stats': stats(v['batch_stats'])}


@pytest.fixture(scope='module')
def flagship():
    """(cfg, JAX segmentor, its variables, a batch with ignored pixels)."""
    cfg = _flagship_cfg(tiny=True)
    cfg['decode_head']['dropout_ratio'] = 0.0
    jm = jax_build(cfg)
    variables = _jax_variables(jm)
    rng = np.random.RandomState(3)
    img = rng.rand(2, 32, 32, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(2, 32, 32) < 0.1] = 255
    return cfg, jm, variables, img, gt


def _port(cfg, variables):
    tm = build_segmentor(cfg)
    tm.load_state_dict(jax_to_torch_state(variables), strict=True)
    return tm.to(memory_format=torch.channels_last)


def _assert_state_close(tm, jax_variables, params, **tol):
    """The port's state_dict against the JAX variables: the BN running
    stats always, the parameters when ``params``."""
    ref = jax_to_torch_state(_np(jax_variables))
    sd = tm.state_dict()
    stats = [k for k in ref if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in ref:
        if k.endswith('num_batches_tracked'):
            assert int(sd[k]) == STEPS, k
        elif k in stats or params:
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(),
                                       err_msg=k, **tol)


def test_first_step_gradients_match_jax(flagship):
    cfg, jm, variables, img, gt = flagship

    def loss_fn(params):
        losses, _ = jm.compute_losses(
            {'params': params, 'batch_stats': variables['batch_stats']},
            img, gt, jax.random.PRNGKey(0), train=True)
        return jax_total(losses)[0]

    jgrad = jax_to_torch_state(
        {'params': _np(jax.jit(jax.grad(loss_fn))(variables['params']))})
    tm = _port(cfg, variables).train()
    total, _ = total_loss_from_dict(tm.compute_losses(img, gt))
    total.backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(grads) == sorted(jgrad)
    # the gradients of conv biases before a train-mode BN are 0 up to noise,
    # so the atol scales with the largest gradient of the net (the worst
    # element is off by 6e-6 of it beyond the rtol)
    scale = max(g.abs().max().item() for g in jgrad.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrad[k].numpy(), rtol=1e-3,
                                   atol=3e-5 * scale, err_msg=k)


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_train_steps_match_jax(flagship, opt):
    """3 steps of make_train_step against JAX's: the per-step losses, the
    final BN running stats, and the final parameters (SGD with momentum
    and weight decay: closely; Adam under the poly schedule: within
    2·steps·lr)."""
    cfg, jm, variables, img, gt = flagship
    if opt == 'sgd':
        ocfg = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)
        lr_config = None
    else:
        ocfg = dict(type='Adam', lr=ADAM_LR, betas=(0.9, 0.999))
        lr_config = dict(policy='poly', power=0.9, min_lr=1e-4,
                         by_epoch=False)
    tx = build_optimizer_tx(ocfg, jax_schedule(lr_config, ocfg['lr'], 10))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    jstep = jax_train_step(jm, tx, donate=False)
    tm = _port(cfg, variables)
    step = make_train_step(tm, build_optimizer(tm, ocfg),
                           build_lr_schedule(lr_config, ocfg['lr'], 10))
    p0 = {k: p.detach().clone() for k, p in tm.named_parameters()}
    for i in range(STEPS):
        state, jlogs = jstep(state, img, gt, jax.random.PRNGKey(0))
        logs = step(img, gt)
        assert sorted(logs) == sorted(jlogs)
        for k in jlogs:
            assert logs[k].ndim == 0
            np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
        if i == 0:
            g1 = {k: p.grad.clone() for k, p in tm.named_parameters()}
            moves1 = _moves(tm, p0, state.variables)
    assert tm.training
    if opt == 'sgd':
        _assert_state_close(tm, state.variables, True, rtol=1e-4, atol=1e-6)
    else:
        # the stats of steps 2 and 3 come from parameters that differ by
        # up to ±lr per coordinate: 4.6e-4 at most
        _assert_state_close(tm, state.variables, False, rtol=1e-3, atol=1e-3)
        _assert_state_close(tm, state.variables, True, rtol=0,
                            atol=2 * STEPS * ADAM_LR)
        # Where the first gradient is well above its noise (3e-5 of the
        # largest, test_first_step_gradients_match_jax), Adam's moves must
        # agree. Step 1 moves each such coordinate by -lr·sign(g) on both
        # sides: to one f32 ulp of the parameter (1.2e-7 seen), held to
        # lr/1000. After 3 steps the later gradients follow step 1's
        # noise-signed moves elsewhere: 0.09·lr seen, held to 0.2·lr, under
        # the ~lr a step moves each coordinate.
        scale = max(g.abs().max().item() for g in g1.values())
        _assert_moves_close(moves1, g1, 1e-3 * scale, atol=1e-3 * ADAM_LR)
        _assert_moves_close(_moves(tm, p0, state.variables), g1,
                            1e-2 * scale, atol=0.2 * ADAM_LR)


def _moves(tm, p0, jax_variables):
    """{name: (the port's p - p0, JAX's p - p0)} over the parameters."""
    ref = jax_to_torch_state(_np(jax_variables))
    return {k: (p.detach() - p0[k], ref[k] - p0[k])
            for k, p in tm.named_parameters()}


def _assert_moves_close(moves, g1, floor, atol):
    """The port's parameter moves against JAX's on the coordinates whose
    first gradient is at least ``floor``; most of the net takes part."""
    compared = total = 0
    for k, (move, jmove) in moves.items():
        strong = g1[k].abs() >= floor
        compared += int(strong.sum())
        total += strong.numel()
        np.testing.assert_allclose(move[strong].numpy(),
                                   jmove[strong].numpy(), rtol=0, atol=atol,
                                   err_msg=k)
    assert compared >= total // 4, (compared, total)


def test_parse_losses_and_val_step(flagship):
    """_parse_losses against the JAX one; train_step/forward(return_loss)
    give the same losses as compute_losses; the val step takes the
    running stats, leaves them and restores the mode."""
    cfg, _, variables, img, gt = flagship
    rng = np.random.RandomState(4)
    losses = {'decode.loss_ce': rng.rand(3).astype(np.float32),
              'decode.loss_dice': [rng.rand(2).astype(np.float32),
                                   rng.rand(1).astype(np.float32)],
              'decode.acc_seg': rng.rand(1).astype(np.float32)}
    loss, log_vars = BaseSegmentor._parse_losses(
        {k: [torch.from_numpy(a) for a in v] if isinstance(v, list)
         else torch.from_numpy(v) for k, v in losses.items()})
    jloss, jlog_vars = JBase._parse_losses(
        {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
         else jnp.asarray(v) for k, v in losses.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert log_vars.keys() == jlog_vars.keys()
    np.testing.assert_allclose(list(log_vars.values()),
                               list(jlog_vars.values()), rtol=1e-6)

    tm = _port(cfg, variables).train()
    metas = [{}] * 2
    out = tm.train_step(dict(img=img, img_metas=metas,
                             gt_semantic_seg=gt[:, None]))
    assert out['num_samples'] == 2 and out['loss'].requires_grad
    direct = tm(img=img, img_metas=metas, gt_semantic_seg=gt[..., None])
    assert sorted(direct) == ['decode.acc_seg', 'decode.loss_bce',
                              'decode.loss_dice']
    stats = {k: v.clone() for k, v in tm.state_dict().items()}
    val = make_val_step(tm)(img, gt)
    assert tm.training
    assert all(torch.equal(v, stats[k]) for k, v in tm.state_dict().items())
    tm.eval()
    with torch.no_grad():
        _, ref = total_loss_from_dict(tm.compute_losses(img, gt))
    for k in ref:
        torch.testing.assert_close(val[k], ref[k])


def test_train_step_rejects_what_is_not_ported():
    cfg = _flagship_cfg(tiny=True)
    tm = build_segmentor(cfg)
    opt = build_optimizer(tm, dict(type='Adam', lr=1e-3))
    with pytest.raises(TypeError, match='DeviceMesh or a ProcessGroup'):
        make_train_step(tm, opt, mesh=object())
