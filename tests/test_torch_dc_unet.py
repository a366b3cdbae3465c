"""The port's DC-UNet (``EncoderDecoderFull`` + ``DC_Unet``) against the
JAX package, on the CPU, at ``nf=4`` and 32² (the JAX test's size,
``tests/test_models/test_heads/test_monolithic_heads.py``). Helpers and
tolerances: ``tests/fixtures/torch_monolithic.py``."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models.decode_heads import dc_unet_head as jdc
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import dc_unet_head as tdc
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 32
HEAD = dict(type='DC_Unet', out_channels=2, nf=4, norm_cfg=dict(type='BN'))


@pytest.fixture(scope='module')
def models():
    return mono.build_pair(mono.full_cfg(HEAD), SIZE)


def test_every_flax_leaf_maps_to_a_port_key(models):
    jm, tm = models
    assert mono.check_leaves_and_count(*models) == 161520
    sd = jax_to_torch_state(jm.variables, tm)
    # the BN after a relu conv has no affine parameters, the tanh one has
    assert 'decode_head.mres_block1.conv3x3.1.weight' not in sd
    assert 'decode_head.mres_block1.conv3x3.1.running_mean' in sd
    assert 'decode_head.mres_block1.conv2d_bn.1.weight' in sd
    assert sd['decode_head.conv10.1.weight'].shape == (2,)
    assert sd['decode_head.res_path1.blocks.2.conv2d_bn2.0.weight'].shape \
        == (4, 4, 3, 3)
    assert sd['decode_head.deconv1.deconv.weight'].shape == (105, 32, 2, 2)


def test_eval_logits_match_jax(models):
    ref = mono.check_logits(*models, SIZE)
    # the tanh output: bounded, and not constant
    assert np.abs(ref).max() <= 1 and ref.std() > 1e-2


def test_train_steps_match_jax(models):
    jm, _ = models
    cfg = mono.full_cfg(HEAD)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


def _jax_apply(module, x, seed, train=False):
    """``module`` with numpy-drawn variables applied to x (NHWC) by JAX:
    the output, and the variables."""
    v = random_variables(module, jnp.asarray(x), seed=seed)
    if train:
        out, _ = jax.jit(lambda v_, x_: module.apply(
            v_, x_, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    else:
        out = jax.jit(module.apply)(v, jnp.asarray(x))
    return np.asarray(out), v


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize('k', [1, 2, 3, 4])
def test_reflect_same_padding_matches_jax(k):
    """``Conv2dSame``: reflect padding of k//2 before and, for an even k,
    one fewer after; the output keeps the input's size. Zero padding
    would differ at the border."""
    x = np.random.RandomState(k).randn(2, 7, 6, 3).astype(np.float32)
    ref, v = _jax_apply(jdc.Conv2dSame(5, k), x, seed=1)
    conv = tdc.Conv2dSame(3, 5, k)
    conv.load_state_dict(jax_to_torch_state(v, conv), strict=True)
    with torch.no_grad():
        out = conv(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == (2, 7, 6, 5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if k > 1:
        with torch.no_grad():
            zero = torch.nn.functional.conv2d(
                torch.nn.functional.pad(_nchw(x), conv.pads), conv.weight,
                conv.bias)
        assert np.abs(zero.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-3


@pytest.mark.parametrize('activation', ['relu', 'sigmoid', None, 'tanh'])
@pytest.mark.parametrize('train', [False, True])
def test_conv_bn_affine_only_without_relu_or_sigmoid(activation, train):
    """``ConvBn``: BN has a weight and bias only when the activation is
    neither relu nor sigmoid (``affine=False``: the JAX brick's scale of
    ones and bias of zeros), in eval and in training."""
    x = np.random.RandomState(0).randn(3, 6, 6, 4).astype(np.float32)
    ref, v = _jax_apply(jdc.ConvBn(5, 3, activation=activation), x, seed=2,
                        train=train)
    mod = tdc.ConvBn(4, 5, 3, activation=activation)
    affine = activation not in ('relu', 'sigmoid')
    assert mod[1].affine == affine
    assert ('1' in v['params']) == affine    # the BN's scale and bias
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    mod.train(train)
    with torch.no_grad():
        out = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_deconv_kernel_is_flipped_by_the_bridge():
    """``Deconv2x`` (flax ``ConvTranspose`` k=2 s=2) against torch's
    ``ConvTranspose2d``: the bridge flips the kernel in both spatial
    axes; unflipped, every shape matches and the output does not."""
    x = np.random.RandomState(3).randn(2, 5, 4, 6).astype(np.float32)
    ref, v = _jax_apply(jdc.Deconv2x(7), x, seed=4)
    mod = tdc.Deconv2x(6, 7)
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    with torch.no_grad():
        out = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == (2, 10, 8, 7)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    mod.deconv.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(
        np.transpose(v['params']['deconv']['kernel'], (2, 3, 0, 1)))))
    with torch.no_grad():
        wrong = mod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - ref).max() > 1e-2


@pytest.mark.parametrize('u', [4, 8, 32, 64, 512])
def test_branch_widths_truncate_as_in_jax(u):
    """``int`` truncation of each of the three branch widths, then their
    sum: 51 channels for nf=32, not int(1.67·32) = 53."""
    assert tdc.dc_out_channel(u) == jdc.dc_out_channel(u)
    block = tdc.DCBlock(3, u)
    widths = [block.conv3x3[0].out_channels, block.conv5x5[0].out_channels,
              block.conv7x7[0].out_channels]
    w = 1.67 * u
    assert widths == [int(w * 0.167), int(w * 0.333), int(w * 0.5)]
    assert block.bn_2.num_features == sum(widths) == jdc.dc_out_channel(u)


def test_dropout_only_with_use_dropout():
    """``Dropout(0.5)`` on the decoder blocks' inputs with ``use_dropout``,
    nowhere without it; drawn from the caller's generator."""
    m = build_segmentor(mono.full_cfg(HEAD))
    assert not [n for n, _ in m.named_modules() if n.endswith('dropout')]
    m = build_segmentor(mono.full_cfg(dict(HEAD, use_dropout=True)))
    assert sorted(n for n, _ in m.named_modules() if n.endswith('dropout')) \
        == [f'decode_head.mres_block{i}.dropout' for i in (6, 7, 8)]
    block = m.decode_head.mres_block6.train()
    x = torch.rand(2, 64, 4, 4)
    a = block(x, torch.Generator().manual_seed(0))
    b = block(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.slow
@pytest.mark.parametrize('with_cp', [True, 'hires'])
def test_with_cp_steps_match_jax(models, with_cp):
    """``with_cp`` ``True`` and ``'hires'`` against JAX's ``nn.remat``
    tiers (``DC_Unet._blk``): three Adam steps as
    ``test_train_steps_match_jax`` holds them. ``slow``: each compiles a
    JAX remat step; tier-1 holds each tier to the port's plain step
    (``tests/test_torch_remat.py``), which is held to JAX above."""
    jm, _ = models
    cfg = mono.full_cfg(dict(HEAD, with_cp=with_cp))
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


def test_config_builds_at_full_width():
    """``my_config/DC-UNet.py`` (nf=32): the JAX parameter count, and 51
    channels out of the first block."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'DC-UNet.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == 10811124
    assert m.decode_head.mres_block1.bn_2.num_features == 51
    assert m.out_channels == 2
