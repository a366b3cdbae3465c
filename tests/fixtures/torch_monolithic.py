"""Helpers of the tests that hold the port's monolithic models
(``EncoderDecoderFull``: DC-UNet, UNet++, TransUNet, SwinUNet) and U-Net
to the JAX package on the CPU, at tiny widths.

JAX variables are drawn with numpy from a seed in the shapes of the JAX
init at the test's input size (``random_variables``), carried into the
port by ``jax_to_torch_state`` and loaded with ``strict=True``.

Tolerances, all in f32: eval logits at rtol 1e-4 / atol 1e-5 (the
STC-UNet precedent, ``tests/test_torch_stc_unet.py``). Each of three
Adam steps of ``make_train_step`` is taken from the state JAX's step
started from (``check_train_steps`` says why) and held as
``tests/test_torch_maxvit.py`` and ``tests/test_torch_train_step.py``
hold a step: the log vars to rtol 1e-5, every parameter within 2·lr, the
moves of coordinates whose first gradient is at least 1e-3 of the
largest to lr/1000 in the first step (where Adam's move is lr times the
gradient's sign) and to 0.2·lr in the later ones (where it follows the
gradient's ratio to its running moments, which cancel where the gradient
turned), the BN running stats (taken from the same weights) to rtol
1e-4 / atol 1e-5 as ``chip_smoke.py``'s ``train_check`` holds them, and
``num_batches_tracked``. The two frameworks'
random draws cannot match, so the train steps run with every dropout
and drop-path rate at 0 on both sides: the JAX modules that hard-code a
rate (ViT's dropout, SwinUNet's stochastic depth) get flax's
``nn.Dropout`` and ``swin_core.drop_path`` patched to the identity for
the test, and the port's modules get their rates set to 0 after
building.
"""
import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.serialization import to_state_dict

from stc_unet_tpu.core import build_lr_schedule as jax_schedule
from stc_unet_tpu.core import build_optimizer_tx
from stc_unet_tpu.engine import TrainState
from stc_unet_tpu.engine import make_train_step as jax_train_step
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu.models.utils import swin_core as jax_swin_core
from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.engine import make_train_step
from stc_unet_tpu_torch.engine.checkpoint import load_opt_state
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.bricks import Dropout, Dropout2d
from stc_unet_tpu_torch.models.utils.swin_core import DropPath
from stc_unet_tpu_torch.utils import jax_to_torch_state
from stc_unet_tpu_torch.utils.jax_convert import port_key
from tests.fixtures.torch_port import random_variables

LOSSES = [dict(type='CrossEntropyLoss', use_sigmoid=False,
               loss_name='loss_bce', loss_weight=1.0),
          dict(type='DiceLoss', loss_name='loss_dice', loss_weight=1.0)]
STEPS = 3
ADAM_LR = 1e-3
OPTIMIZER = dict(type='Adam', lr=ADAM_LR, betas=(0.9, 0.999))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)


def full_cfg(head):
    """An ``EncoderDecoderFull`` over ``head`` (the loss of the configs in
    ``my_config/``), whole mode."""
    return dict(type='EncoderDecoderFull',
                decode_head=dict(head, loss_decode=LOSSES),
                test_cfg=dict(mode='whole'))


def build_pair(cfg, size, seed=0):
    """(JAX segmentor with numpy-drawn variables at ``size``², the port's
    model with them, loaded strictly)."""
    jm = jax_build(cfg)
    jm.variables = random_variables(
        jm.net, jnp.zeros((1, size, size, 3)), seed=seed, train=False,
        method=EncoderDecoderNet.forward_heads)
    tm = build_segmentor(cfg)
    tm.load_state_dict(jax_to_torch_state(jm.variables, tm), strict=True)
    return jm, tm.to(memory_format=torch.channels_last)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_leaves_and_count(jm, tm):
    """Each flax leaf maps to its own port key of the same size (plus a
    ``num_batches_tracked`` a BN and the Swin backbone's
    ``relative_position_index`` a bias table), the key sets are equal,
    and the JAX parameter count is the port's."""
    sd = jax_to_torch_state(jm.variables, tm)
    found = [(c, p, v) for c in ('params', 'batch_stats')
             for p, v in leaves(jm.variables.get(c, {}))]
    bn = sum(1 for c, p, _ in found if c == 'batch_stats' and
             p[-1] == 'mean')
    index = sum(1 for k in sd if k.endswith('.relative_position_index'))
    assert len(sd) == len(found) + bn + index
    assert sorted(sd) == sorted(tm.state_dict())
    port = tm.state_dict()
    for k, v in sd.items():
        assert v.shape == port[k].shape, k
    jax_params = sum(int(np.prod(v.shape)) for c, _, v in found
                     if c == 'params')
    assert jax_params == sum(p.numel() for p in tm.parameters())
    return jax_params


def check_round_trip(v, module):
    """Each flax leaf of ``v`` lands on its own key of ``module`` (plus a
    ``num_batches_tracked`` a BN), the key sets are equal, and the
    inverse layout of each port tensor (by its ``port_key`` tag, a bare
    4-D kernel by its module's type) is the leaf, bit for bit."""
    sd, modules = module.state_dict(), dict(module.named_modules())
    found = [(c, p, x) for c in ('params', 'batch_stats')
             for p, x in leaves(v.get(c, {}))]
    keys = set()
    for c, path, x in found:
        key, tag = port_key(path, c, modules)
        keys.add(key)
        t = sd[key].numpy()
        if tag == 'kernel' and t.ndim == 4:
            tag = 'deconv_w' if isinstance(
                modules[key.rpartition('.')[0]],
                torch.nn.ConvTranspose2d) else 'conv_w'
        if tag == 'deconv_w':
            t = np.transpose(t, (2, 3, 0, 1))[::-1, ::-1]
        elif tag == 'conv_w':
            t = np.transpose(t, (2, 3, 1, 0))
        elif tag in ('linear_w', 'kernel'):
            t = t.T
        np.testing.assert_array_equal(t, np.asarray(x), err_msg=key)
    bn = {k[:-len('running_mean')] + 'num_batches_tracked' for k in keys
          if k.endswith('running_mean')}
    assert len(keys) == len(found)
    assert sorted(keys | bn) == sorted(sd)


def image(n, size, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def check_logits(jm, tm, size, n=2, seed=0, atol=1e-5):
    """Eval logits of ``encode_decode`` to JAX's (rtol 1e-4, ``atol``),
    and the entry point's label maps to JAX's argmax."""
    img = image(n, size, seed)
    ref = np.asarray(jm.encode_decode(img))
    out = tm.encode_decode(img)
    assert out.shape == (n, size, size, tm.out_channels)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=atol)
    metas = [dict(ori_shape=(size, size, 3), img_shape=(size, size, 3),
                  pad_shape=(size, size, 3), flip=False)] * n
    preds = tm(return_loss=False, img=[img], img_metas=[metas])
    assert np.mean(np.asarray(preds) == ref.argmax(-1)) >= 0.999
    return ref


class _Identity(fnn.Module):
    """flax's ``nn.Dropout`` signature, returning its input."""
    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: object = None
    rng_collection: str = 'dropout'

    def __call__(self, x, deterministic=None, rng=None):
        return x


@contextlib.contextmanager
def jax_dropout_off():
    """flax's ``nn.Dropout`` and the JAX ``swin_core.drop_path`` as the
    identity, for the JAX modules that hard-code their rates."""
    saved = fnn.Dropout, jax_swin_core.drop_path
    fnn.Dropout = _Identity
    jax_swin_core.drop_path = lambda x, *args, **kwargs: x
    try:
        yield
    finally:
        fnn.Dropout, jax_swin_core.drop_path = saved


def port_dropout_off(tm):
    """Every dropout and drop-path rate of the port's model at 0."""
    n = 0
    for m in tm.modules():
        if isinstance(m, (Dropout, Dropout2d)):
            m.p, n = 0.0, n + 1
        elif isinstance(m, DropPath):
            m.rate, n = 0.0, n + 1
    return n


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def train_batch(size, n=2, seed=3):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, size, size, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(n, size, size) < 0.1] = 255
    return img, gt


def jax_train_run(cfg, variables, img, gt, remat=False, steps=STEPS,
                  optimizer=OPTIMIZER):
    """``steps`` (three) JAX Adam steps (poly lr; or of the ``optimizer``
    cfg, at lr ``ADAM_LR``) with its dropout off (``remat``: the step's
    ``jax.checkpoint`` of the whole loss): the log vars of each step, and
    the variables and optax state before each step and after the last
    (numpy trees; no optax state before the first)."""
    jm = jax_build(cfg)
    tx = build_optimizer_tx(optimizer, jax_schedule(LR_CONFIG, ADAM_LR, 10),
                            params=variables['params'])
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    jstep = jax_train_step(jm, tx, donate=False, remat=remat)
    logs, states = [], [(variables, None)]
    with jax_dropout_off():
        for _ in range(steps):
            state, lv = jstep(state, img, gt, jax.random.PRNGKey(0))
            logs.append({k: float(v) for k, v in lv.items()})
            states.append((_np(state.variables),
                           _np(to_state_dict(state.opt_state))))
    return logs, states


def check_train_steps(cfg, img, gt, jax_run, remat=False, min_agree=None,
                      bn_calls=None, optimizer=OPTIMIZER, acc_pixels=None):
    """Each of the JAX Adam steps of ``jax_run``
    (:func:`jax_train_run`, with the same ``optimizer``) against one port
    step from the same state:
    the JAX variables and optax state before that step
    (``engine.load_opt_state``), the schedule at that step, every dropout
    rate at 0 (``remat``: ``make_train_step(remat=True)``). Returns the
    share of coordinates whose moves were held (those of a strong first
    gradient). With ``min_agree`` the moves must agree on at least that
    share of those coordinates in each step, not on all: for a model
    whose JAX f32 gradient is itself far from exact (the ResNet-50
    models, ``tests/test_torch_psp_aspp.py``). ``bn_calls`` gives, for a
    ``num_batches_tracked`` key, how often its BN runs in a training
    forward (torch counts each call; 1 if None): for a model that applies
    one BN more than once (MultiResUnet). ``acc_pixels`` holds each
    ``*acc_seg`` (a percentage of the labelled pixels) within that many
    pixels instead of rtol 1e-5: for a model whose JAX f32 forward is
    itself noisy enough to flip a pixel near a class boundary (the stock
    PSPNet's train-mode BN bottlenecks, ``tests/test_torch_aux_heads.py``),
    as ``chip_smoke.py``'s ``train_check`` holds the card to the CPU.

    Each step starts from JAX's state because Adam turns gradients that
    are f32 noise into whole moves of up to lr: the weights of a ReLU
    channel that is dead on the batch, the biases of convs before a
    train-mode BN. Two correct runs then drift apart: in U-Net one such
    weight moves the second step's loss by 1.5e-5 of itself, and DC-UNet
    at ``nf=4`` is chaotic enough that a one-ulp nudge of its own weights
    moves its third loss by 4.8e-5."""
    jlogs, states = jax_run
    schedule = build_lr_schedule(LR_CONFIG, ADAM_LR, 10)
    tracked = None
    for i in range(len(jlogs)):
        (before, opt_state), (after, _) = states[i], states[i + 1]
        tm = build_segmentor(cfg)
        sd = jax_to_torch_state(before, tm)
        if tracked is not None:
            sd.update(tracked)
        tm.load_state_dict(sd, strict=True)
        tm = tm.to(memory_format=torch.channels_last)
        port_dropout_off(tm)
        opt = build_optimizer(tm, optimizer)
        if opt_state is not None:
            load_opt_state(opt, tm, opt_state)
        step = make_train_step(tm, opt,
                               lambda k, i=i: schedule(k + i), remat=remat)
        logs = step(img, gt, torch.Generator().manual_seed(i))
        assert sorted(logs) == sorted(jlogs[i])
        pixel = 100.0 / int((np.asarray(gt) != 255).sum())
        for k, v in jlogs[i].items():
            if acc_pixels is not None and k.endswith('acc_seg'):
                np.testing.assert_allclose(logs[k].item(), v, rtol=0,
                                           atol=acc_pixels * pixel,
                                           err_msg=f'step {i}: {k}')
                continue
            np.testing.assert_allclose(logs[k].item(), v, rtol=1e-5,
                                       err_msg=f'step {i}: {k}')
        p0, ref = (jax_to_torch_state(before, tm),
                   jax_to_torch_state(after, tm))
        state = tm.state_dict()
        if i == 0:
            g1 = {k: p.grad.clone() for k, p in tm.named_parameters()}
            scale = max(g.abs().max().item() for g in g1.values())
            strong = {k: g.abs() >= 1e-3 * scale for k, g in g1.items()}
            share = sum(int(m.sum()) for m in strong.values()) / sum(
                m.numel() for m in strong.values())
        agree = held = 0
        # two moves of opposite sign differ by 2·lr; where one may turn
        # (``min_agree``), by that plus the parameter's f32 rounding
        bound = 2 * ADAM_LR if min_agree is None else 2 * ADAM_LR + 1e-6
        for k, m in strong.items():
            np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(),
                                       rtol=0, atol=bound,
                                       err_msg=f'step {i}: {k}')
            move, jmove = (state[k] - p0[k])[m], (ref[k] - p0[k])[m]
            atol = (1e-3 if i == 0 else 0.2) * ADAM_LR
            if min_agree is None:
                np.testing.assert_allclose(move.numpy(), jmove.numpy(),
                                           rtol=0, atol=atol,
                                           err_msg=f'step {i}: {k}')
            agree += int(((move - jmove).abs() <= atol).sum())
            held += int(m.sum())
        if min_agree is not None:
            assert agree >= min_agree * held, (i, agree, held)
        for k in ref:
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f'step {i}: {k}')
            elif k.endswith('num_batches_tracked'):
                calls = 1 if bn_calls is None else bn_calls(k)
                assert int(state[k]) == (i + 1) * calls, k
        tracked = {k: v for k, v in state.items()
                   if k.endswith('num_batches_tracked')}
    # a tenth of the coordinates at least (SwinUNet 19 %: most of its
    # weights are in the 1x1 stage, whose gradients are small)
    assert share >= 0.1, share
    return share
