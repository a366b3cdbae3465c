"""The port's TransUNet (``EncoderDecoderFull`` + ``TransUNet``) and its
ViT against the JAX package, on the CPU, at the JAX test's tiny size
(``tests/test_models/test_heads/test_monolithic_heads.py``: img_dim 32,
encoder width 16, 4 heads, mlp_dim 32, 2 blocks, 32² images). Helpers and
tolerances: ``tests/fixtures/torch_monolithic.py``; the ViT modules at
rtol 1e-5 / atol 1e-6."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stc_unet_tpu.models.decode_heads import transunet_head as jtu
from stc_unet_tpu.models.decode_heads import vit as jvit
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import transunet_head as ttu
from stc_unet_tpu_torch.models.decode_heads import vit as tvit
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 32
HEAD = dict(type='TransUNet', img_dim=32, in_channels=3, out_channels=16,
            head_num=4, mlp_dim=32, block_num=2, patch_dim=16, class_num=2)


@pytest.fixture(scope='module')
def models():
    return mono.build_pair(mono.full_cfg(HEAD), SIZE)


def test_every_flax_leaf_maps_to_a_port_key(models):
    jm, tm = models
    assert mono.check_leaves_and_count(*models) == 1188198
    sd = jax_to_torch_state(jm.variables)
    assert sd['decode_head.vit.cls_token'].shape == (1, 1, 128)
    assert sd['decode_head.vit.embedding'].shape == (5, 128)
    assert sd['decode_head.vit.layer_blocks.1.multi_head_attention.'
              'qkv_layer.weight'].shape == (384, 128)
    assert sd['decode_head.encoder3.downsample_0.weight'].shape == \
        (128, 64, 1, 1)
    # no cls_seg: the head ends in conv_out
    assert not [k for k in sd if 'conv_seg' in k]
    assert tm.out_channels == 2


def test_eval_logits_match_jax(models):
    mono.check_logits(*models, SIZE)


def test_train_steps_match_jax(models):
    """The ViT's hard-coded dropout of 0.1 is off on both sides."""
    jm, _ = models
    cfg = mono.full_cfg(HEAD)
    assert mono.port_dropout_off(build_segmentor(cfg)) == 1 + 2 * 2
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


def _tokens(b=2, t=5, c=16, seed=0):
    return np.random.RandomState(seed).randn(b, t, c).astype(np.float32)


def test_attention_splits_qkv_head_last_and_multiplies_the_scale():
    """The packed ``qkv_layer`` output splits as (head_dim, 3, heads) and
    the scores are multiplied by sqrt(head_dim); the usual (3, heads,
    head_dim) split, or a division by sqrt(head_dim), gives another
    result."""
    x = _tokens()
    jmod = jvit.MultiHeadAttention(16, 4)
    v = random_variables(jmod, jnp.asarray(x), seed=1)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = tvit.MultiHeadAttention(16, 4)
    mod.load_state_dict(jax_to_torch_state(v), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
        qkv = mod.qkv_layer(torch.from_numpy(x))
        usual = qkv.reshape(2, 5, 3, 4, 4).permute(2, 0, 3, 1, 4)
        q, k, w = usual[0], usual[1], usual[2]
        other = {
            'split': torch.softmax(q @ k.transpose(-1, -2) * 2.0, -1) @ w,
        }
        q, k, w = (qkv.reshape(2, 5, 4, 3, 4)[:, :, :, i].permute(0, 3, 1, 2)
                   for i in range(3))
        other['scale'] = torch.softmax(q @ k.transpose(-1, -2) / 2.0, -1) @ w
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    for name, o in other.items():
        o = mod.out_attention(o.transpose(1, 2).reshape(2, 5, 16))
        assert np.abs(o.detach().numpy() - ref).max() > 1e-3, name


@pytest.mark.parametrize('p,size', [(1, 4), (2, 4), (2, 6)])
def test_vit_matches_jax_patch_factor_slow(p, size):
    """The whole ViT in eval (post-LN blocks, exact GELU, cls token, the
    position embedding sliced to the tokens), with the patch factor on the
    slow axis of each side, which at patch 2 is not the usual p×p blocks.
    ``img_dim`` 8 holds more positions than a side of 4 or 6 uses."""
    x = np.random.RandomState(p).randn(2, size, size, 3).astype(np.float32)
    jmod = jvit.ViT(8, 3, 16, 4, 24, 2, patch_dim=p)
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = tvit.ViT(8, 3, 16, 4, 24, 2, patch_dim=p).eval()
    mod.load_state_dict(jax_to_torch_state(v), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == ((2, (size // p) ** 2, 16))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    n = size // p
    blocks = x.reshape(2, n, p, n, p, 3).transpose(0, 1, 3, 2, 4, 5)
    slow = mod.patchify(torch.from_numpy(x)).numpy()
    assert np.array_equal(slow, blocks.reshape(2, n * n, -1)) == (p == 1)


def test_encoder_bottleneck_strides_its_3x3_whatever_stride_says():
    assert ttu.EncoderBottleneck(4, 8, stride=1).conv2.stride == (2, 2)
    x = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    jmod = jtu.EncoderBottleneck(8, stride=2)
    v = random_variables(jmod, jnp.asarray(x), seed=5)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = ttu.EncoderBottleneck(4, 8, stride=2).eval()
    mod.load_state_dict(jax_to_torch_state(v), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_decoder_bottleneck_aligns_corners_and_puts_the_skip_first():
    """×2 with ``align_corners=True``, the skip before the upsampled map;
    either the other corner rule or the other order gives another
    result."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    skip = rng.randn(2, 6, 8, 3).astype(np.float32)
    jmod = jtu.DecoderBottleneck(4)
    v = random_variables(jmod, jnp.asarray(x), jnp.asarray(skip), seed=7)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x),
                                         jnp.asarray(skip)))
    mod = ttu.DecoderBottleneck(8, 4).eval()
    mod.load_state_dict(jax_to_torch_state(v), strict=True)
    xt, st = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, skip))

    def layers(t):
        t = F.relu(mod.layer_1(mod.layer_0(t)))
        return F.relu(mod.layer_4(mod.layer_3(t))).permute(0, 2, 3, 1)

    with torch.no_grad():
        out = mod(xt, st).permute(0, 2, 3, 1).numpy()
        up = {a: F.interpolate(xt, scale_factor=2, mode='bilinear',
                               align_corners=a) for a in (True, False)}
        same = layers(torch.cat([st, up[True]], 1)).numpy()
        others = [layers(torch.cat([up[True], st], 1)).numpy(),
                  layers(torch.cat([st, up[False]], 1)).numpy()]
    assert out.shape == (2, 6, 8, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(same, ref, rtol=1e-5, atol=1e-5)
    for o in others:
        assert np.abs(o - ref).max() > 1e-3


def test_a_smaller_image_slices_the_position_embedding():
    """``img_dim`` 64 sizes the embedding for 4x4 tokens; a 32² image has
    2x2 and takes the first 5 rows, in both packages."""
    cfg = mono.full_cfg(dict(HEAD, img_dim=64))
    jm, tm = mono.build_pair(cfg, SIZE, seed=3)
    assert tm.decode_head.vit.embedding.shape == (17, 128)
    mono.check_logits(jm, tm, SIZE, n=1)


def test_config_builds_at_full_width():
    """``my_config/TransUnet.py``: the config's ``out_channels`` (128) is
    the encoder width; the head's own stays at its default."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'TransUnet.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == 67865730
    head = m.decode_head
    assert head.out_channels is None and m.out_channels == 2
    assert head.vit.embedding.shape == (1025, 1024)
    assert head.encoder3.conv3.out_channels == 1024
