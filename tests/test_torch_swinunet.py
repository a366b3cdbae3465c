"""The port's SwinUNet (``EncoderDecoderFull`` + ``SwinUNet``) and its
Swin blocks against the JAX package, on the CPU, at the JAX test's tiny
size (``tests/test_models/test_heads/test_monolithic_heads.py``:
img_size 64, patch 8, window 4, out_channel 8, 64² images): the patch
grid is 8x8, so stage 0 crosses the shift mask (windows of 4, shift 2)
and stages 1 to 3 (4x4, 2x2, 1x1) shrink the window to the map. The JAX
variables are drawn at 64², the input size. Helpers and tolerances:
``tests/fixtures/torch_monolithic.py``; the blocks at rtol 1e-5 / atol
1e-5."""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from stc_unet_tpu.models.utils import swin_core as jsc
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.utils import swin_core as tsc
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 64
HEAD = dict(type='SwinUNet', img_size=64, patch_size=8, window_size=4,
            out_channel=8, num_classes=2)


@pytest.fixture(scope='module')
def models():
    return mono.build_pair(mono.full_cfg(HEAD), SIZE)


def test_every_flax_leaf_maps_to_a_port_key(models):
    jm, tm = models
    assert mono.check_leaves_and_count(*models) > 0
    sd = jax_to_torch_state(jm.variables, tm)
    pre = 'decode_head.swin_unet.'
    assert sd[pre + 'patch_embed.proj.weight'].shape == (96, 3, 8, 8)
    # stage 0 keeps its 4x4 windows; stage 3 shrinks to its 1x1 map
    assert sd[pre + 'layers.0.blocks.1.attn.relative_position_bias_table'] \
        .shape == (49, 3)
    assert sd[pre + 'layers.3.blocks.0.attn.relative_position_bias_table'] \
        .shape == (1, 24)
    assert sd[pre + 'layers_up.0.expand.weight'].shape == (1536, 768)
    assert sd[pre + 'layers_up.3.blocks.1.mlp.fc2.weight'].shape == (96, 384)
    assert sd[pre + 'concat_back_dim_3.weight'].shape == (96, 192)
    assert sd[pre + 'output.weight'].shape == (8, 96, 1, 1)
    assert sd['decode_head.conv_seg.weight'].shape == (2, 8, 1, 1)
    assert not [k for k in sd if 'running' in k]


def test_eval_logits_match_jax(models):
    mono.check_logits(*models, SIZE)


def test_train_steps_match_jax(models):
    """The hard-coded stochastic depth (0.1) and ``cls_seg``'s dropout are
    off on both sides."""
    jm, _ = models
    cfg = mono.full_cfg(dict(HEAD, dropout_ratio=0.0))
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


@pytest.mark.parametrize('h,w,ws,shift', [(8, 8, 4, 2), (16, 8, 4, 1),
                                          (12, 12, 6, 3)])
def test_shift_mask_matches_jax(h, w, ws, shift):
    """-100 between tokens of a window from different regions of the
    rolled map, 0 elsewhere; None without a shift."""
    mask = tsc.shifted_window_mask(h, w, ws, shift)
    np.testing.assert_array_equal(mask, jsc.shifted_window_mask(h, w, ws,
                                                                shift))
    assert set(np.unique(mask)) == {-100.0, 0.0}
    assert mask.shape == (h * w // ws // ws, ws * ws, ws * ws)
    assert tsc.shifted_window_mask(h, w, ws, 0) is None


def _block_pair(res, ws, shift, seed, drop_path=0.0):
    x = np.random.RandomState(seed).randn(
        2, res[0] * res[1], 16).astype(np.float32)
    kw = dict(window_size=ws, shift_size=shift, mlp_ratio=2.0,
              drop_path=drop_path)
    jmod = jsc.SwinTransformerBlock(16, res, 4, **kw)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = tsc.SwinTransformerBlock(16, res, 4, **kw).eval()
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    return mod, out, ref


@pytest.mark.parametrize('res,ws,shift,want', [
    ((8, 8), 4, 2, (4, 2)),      # shifted windows under the mask
    ((8, 8), 4, 0, (4, 0)),
    ((8, 4), 2, 1, (2, 1)),      # a non-square map
    ((4, 4), 4, 2, (4, 0)),      # map == window: the shift is dropped
    ((4, 4), 8, 4, (4, 0)),      # map < window: the window shrinks
])
def test_swin_block_matches_jax_shift_and_shrink(res, ws, shift, want):
    mod, out, ref = _block_pair(res, ws, shift, seed=sum(res) + ws + shift)
    assert (mod.window_size, mod.shift_size) == want
    assert (mod.attn_mask is not None) == (want[1] > 0)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_the_shift_and_its_mask_change_the_output():
    _, shifted, _ = _block_pair((8, 8), 4, 2, seed=3)
    mod, _, _ = _block_pair((8, 8), 4, 2, seed=3)
    mod.attn_mask = None
    x = np.random.RandomState(3).randn(2, 64, 16).astype(np.float32)
    with torch.no_grad():
        unmasked = mod(torch.from_numpy(x)).numpy()
    assert np.abs(unmasked - shifted).max() > 1e-3


@pytest.mark.parametrize('kind', ['merge', 'expand', 'expand4'])
def test_patch_merge_and_expand_orders_match_jax(kind):
    """PatchMerging concatenates (even, even), (odd, even), (even, odd),
    (odd, odd); PatchExpand and FinalPatchExpandX4 split each token into a
    block row by row. A transposed block order gives another result."""
    res, dim = (4, 6), 8
    x = np.random.RandomState(5).randn(2, 24, dim).astype(np.float32)
    jmod, mod = {
        'merge': (jsc.PatchMerging(res, dim), tsc.PatchMerging(res, dim)),
        'expand': (jsc.PatchExpand(res, dim), tsc.PatchExpand(res, dim)),
        'expand4': (jsc.FinalPatchExpandX4(res, dim),
                    tsc.FinalPatchExpandX4(res, dim)),
    }[kind]
    v = random_variables(jmod, jnp.asarray(x), seed=6)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if kind != 'merge':
        s = 2 if kind == 'expand' else 4
        grid = ref.reshape(2, res[0], s, res[1], s, -1)
        transposed = grid.transpose(0, 1, 4, 3, 2, 5).reshape(ref.shape)
        assert np.abs(transposed - ref).max() > 1e-3


def test_bridge_keeps_swin_convs_unflipped_and_flips_deconvs():
    """A bare 4-D flax kernel turns by the type of the port module it
    lands in: under a ``Conv2d`` (SwinUNet's ``patch_embed.proj`` and
    ``output``) into an OIHW weight unflipped, under a
    ``ConvTranspose2d`` flipped; without the model, or under another
    module, it is refused. The patch embed held to JAX: flipped, its 4x4
    kernel gives another result."""
    k = np.random.RandomState(0).randn(2, 2, 3, 4).astype(np.float32)
    v = {'params': {'proj': {'kernel': k}, 'deconv': {'kernel': k}}}
    net = nn.Module()
    net.proj, net.deconv = nn.Conv2d(3, 4, 2), nn.ConvTranspose2d(3, 4, 2)
    sd = jax_to_torch_state(v, net)
    np.testing.assert_array_equal(sd['proj.weight'].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd['deconv.weight'].numpy(),
                                  np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
    with pytest.raises(ValueError, match='pass the model'):
        jax_to_torch_state(v)
    net.proj = nn.Linear(3, 4)
    with pytest.raises(ValueError, match='for a Linear'):
        jax_to_torch_state(v, net)
    x = np.random.RandomState(7).randn(2, 8, 8, 3).astype(np.float32)
    jmod = jsc.PatchEmbed(4, 16)
    v = random_variables(jmod, jnp.asarray(x), seed=8)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    v = {'params': {'patch_embed': v['params']}}
    mod = tsc.PatchEmbed(4, 3, 16)
    sd = {k.split('.', 1)[1]: t for k, t in jax_to_torch_state(
        v, nn.ModuleDict({'patch_embed': mod})).items()}
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        mod.proj.weight.copy_(mod.proj.weight.flip(2, 3))
        flipped = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(flipped - ref).max() > 1e-3


def test_input_side_must_be_img_size(models):
    _, tm = models
    with pytest.raises(ValueError, match='64x64.*got 32x32'):
        tm.encode_decode(mono.image(1, 32))


def test_one_channel_image_is_repeated_to_three(models):
    _, tm = models
    gray = mono.image(1, SIZE)[..., :1]
    np.testing.assert_array_equal(
        tm.encode_decode(gray).numpy(),
        tm.encode_decode(np.repeat(gray, 3, -1)).numpy())


def test_stochastic_depth_per_sample_and_reused_by_the_decoder():
    """Drop-path rates rise from 0 to 0.1 over the encoder's 12 blocks,
    each decoder stage reuses its encoder stage's slice, and a block drops
    whole samples."""
    m = build_segmentor(mono.full_cfg(HEAD)).decode_head.swin_unet
    enc = [[b.drop_path1.rate for b in layer.blocks] for layer in m.layers]
    np.testing.assert_allclose(sum(enc, []), np.linspace(0, 0.1, 12))
    for i in range(1, 4):
        dec = [b.drop_path1.rate for b in m.layers_up[i].blocks]
        assert dec == enc[3 - i]
    block = tsc.SwinTransformerBlock(16, (4, 4), 4, window_size=4,
                                     drop_path=0.5).train()
    rows = []
    block.drop_path1.register_forward_hook(
        lambda mod, args, out: rows.append(args[0].shape[0]))
    block(torch.randn(3, 16, 16), torch.Generator().manual_seed(0))
    assert rows == [3]


def test_pad_to_window_is_refused():
    """``pad_to_window=True`` (the Swin backbone's branch, refused until
    the backbone was ported) keeps the window and the shift where
    SwinUNet's branch shrinks them, and its mask covers the padded
    canvas (a 5x5 map in one 8x8 window); its parity with JAX is in
    ``tests/test_torch_swin_upernet.py``."""
    block = tsc.SwinTransformerBlock(16, (5, 5), 4, window_size=8,
                                     shift_size=4, pad_to_window=True)
    assert (block.window_size, block.shift_size) == (8, 4)
    assert tuple(block.attn_mask.shape) == (1, 64, 64)
    out = block.eval()(torch.randn(2, 25, 16))
    assert out.shape == (2, 25, 16)
    shrunk = tsc.SwinTransformerBlock(16, (5, 5), 4, window_size=8,
                                      shift_size=4)
    assert (shrunk.window_size, shrunk.shift_size) == (5, 0)


def test_config_builds_at_full_width():
    """``my_config/SwinUnet.py``: img_size 512, patch 8, window 16, so
    the stages are 64, 32, 16 and 8 tokens a side; the 8-token stage
    shrinks its window to 8 (a 225-row table), the 16-token stage keeps
    16 without a shift."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'SwinUnet.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == 41545318
    swin = m.decode_head.swin_unet
    tables = [layer.blocks[0].attn.relative_position_bias_table.shape[0]
              for layer in swin.layers]
    assert tables == [961, 961, 961, 225]
    assert [b.shift_size for b in swin.layers[2].blocks] == [0] * 6
    assert swin.layers[0].blocks[1].shift_size == 8
