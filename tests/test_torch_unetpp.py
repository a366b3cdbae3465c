"""The port's UNet++ (``EncoderDecoderFull`` + ``UnetPlusPlus``) against
the JAX package, on the CPU. The VGG16 widths are fixed, so the images
are small instead: 32², the JAX test's size, the fifth level 2x2 (at 16²
that level is 1x1, and its train-mode BN over B=2 values normalizes them
to ±1 whatever they are, which leaves its gradient f32 noise); the logits
are held at the full-width atol, 1e-4. Helpers and tolerances:
``tests/fixtures/torch_monolithic.py``."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models.decode_heads import unetpp_head as jpp
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import unetpp_head as tpp
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 32
HEAD = dict(type='UnetPlusPlus', num_classes=2, norm_cfg=dict(type='BN'))


@pytest.fixture(scope='module')
def models():
    return mono.build_pair(mono.full_cfg(HEAD), SIZE)


def test_every_flax_leaf_maps_to_a_port_key(models):
    jm, _ = models
    assert mono.check_leaves_and_count(*models) == 17204098
    sd = jax_to_torch_state(jm.variables)
    assert sd['decode_head.encoder.s4_conv2.bias'].shape == (512,)
    assert 'decode_head.x_0_1.conv0.bias' not in sd
    assert sd['decode_head.x_0_4.conv0.weight'].shape == (16, 144, 3, 3)
    assert sd['decode_head.conv_seg.weight'].shape == (2, 64, 1, 1)


def test_eval_logits_match_jax(models):
    """At the VGG16's own widths (fan-in up to 4608) the logits are held
    as the full-width STC-UNet and MaxViT-UNet ones are
    (``tests/test_torch_stc_unet.py``): rtol 1e-4, atol 1e-4."""
    mono.check_logits(*models, SIZE, atol=1e-4)


def test_train_steps_match_jax(models):
    jm, _ = models
    cfg = mono.full_cfg(dict(HEAD, dropout_ratio=0.0))
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


@pytest.mark.parametrize('train', [False, True])
def test_vgg16_encoder_levels_match_jax(train):
    """The five VGG16-BN levels (64 at /1 to 512 at /16), in eval and in
    training, at the full-width limits (rtol 1e-4, atol 1e-4)."""
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    jmod = jpp.VGG16Encoder()
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    if train:
        ref, _ = jax.jit(lambda v_, x_: jmod.apply(
            v_, x_, train=True, mutable=['batch_stats']))(v, jnp.asarray(x))
    else:
        ref = jax.jit(jmod.apply)(v, jnp.asarray(x))
    enc = tpp.VGG16Encoder(3).train(train)
    enc.load_state_dict(jax_to_torch_state(v), strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [o.shape[1:] for o in out] == [(64, 32, 32), (128, 16, 16),
                                          (256, 8, 8), (512, 4, 4),
                                          (512, 2, 2)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=1e-4, atol=1e-4)


def test_grid_node_widths_follow_the_dense_skips():
    """Node x_i_j takes row i's columns 0..j-1 and the upsampled node
    below: its input width is their sum."""
    head = build_segmentor(mono.full_cfg(HEAD)).decode_head
    rc, top = (16, 32, 64, 128), (64, 128, 256, 512, 512)
    for j in range(1, 5):
        for i in range(5 - j):
            below = top[i + 1] if j == 1 else rc[i + 1]
            want = top[i] + (j - 1) * rc[i] + below
            assert getattr(head, f'x_{i}_{j}').conv0.in_channels == want


def test_config_builds_at_full_width():
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'UNet++.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == 17204098
    assert m.out_channels == 2 and m.decode_head.dropout_ratio == 0.1
