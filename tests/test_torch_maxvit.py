"""The port's MaxViT-UNet against the JAX package, on the CPU.

The tiny geometry of ``tests/test_models/test_backbones/test_maxvit.py``
(depths 1, 8 channels, 2 heads, 2×2 windows and grids, 64² images). The
JAX variables are drawn with numpy from a seed in the shapes of the JAX
init (BN running stats included) and carried into the port by
``jax_to_torch_state``; inputs are made with numpy too. On the CPU the port's attention is the plain
version of its kernels and JAX's is its einsum chain: the same function in
f32.

Tolerances, all in f32: modules and whole-model logits at rtol 1e-4 /
atol 1e-5 (the STC-UNet precedent, ``tests/test_torch_stc_unet.py``); the
train step as ``tests/test_torch_train_step.py`` holds it (losses rtol
1e-5; Adam's parameter moves to lr/1000 after one step and 0.2·lr after
three where the first gradient is at least 1e-3 of the largest, all
parameters to 2·steps·lr), with every dropout and drop-path rate at 0 on both sides,
since the two frameworks' random draws cannot match.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.core import build_lr_schedule as jax_schedule
from stc_unet_tpu.core import build_optimizer_tx
from stc_unet_tpu.engine import TrainState
from stc_unet_tpu.engine import make_train_step as jax_train_step
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.decode_heads.decode_head import \
    BaseDecodeHead as JHead
from stc_unet_tpu.models.decode_heads.maxvit_decoder import \
    DeconvModule as JDeconv
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu.models.utils.maxvit_core import MaxViTBlock as JBlock
from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.engine import make_train_step
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import BaseDecodeHead
from stc_unet_tpu_torch.models.decode_heads.maxvit_decoder import \
    DeconvModule
from stc_unet_tpu_torch.models.utils.maxvit_core import (MaxViTBlock,
                                                         apply_maxvit_block)
from stc_unet_tpu_torch.models.utils.swin_core import DropPath, drop_path
from stc_unet_tpu_torch.ops import window_attention as twa
from stc_unet_tpu_torch.utils import jax_to_torch_state

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SIZE = 64
LOSSES = [dict(type='CrossEntropyLoss', use_sigmoid=False,
               loss_name='loss_bce', loss_weight=1.0),
          dict(type='DiceLoss', loss_name='loss_dice', loss_weight=1.0)]
STEPS = 3
ADAM_LR = 1e-3


def _cfg(rate=0.1):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='MaxViT', in_channels=3, depths=(1, 1, 1, 1),
                      channels=(8, 8, 8, 8), embed_dim=8, num_heads=2,
                      grid_window_size=(2, 2), attn_drop=rate, drop=rate,
                      drop_path=rate, mlp_ratio=2),
        decode_head=dict(type='MaxViTDecoder', in_channels=[8, 8, 8, 8],
                         output_size=(32, 32), num_heads=2,
                         grid_window_size=(2, 2), depths=(1, 1, 1),
                         channels=8, num_classes=2, mlp_ratio=2.0,
                         attn_drop=rate, drop=rate, drop_path=rate,
                         dropout_ratio=rate, loss_decode=LOSSES),
        test_cfg=dict(mode='whole'))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_variables(module, *args, seed=0, **kwargs):
    """Variables for ``module.init(key, *args, **kwargs)``, drawn with numpy
    instead of the JAX init (whose compile costs more than the test): the
    tree's shapes come from ``jax.eval_shape``, which compiles nothing.
    Kernels are uniform in ±1/sqrt(fan-in), biases within ±0.1, scales
    near 1, the relative-position tables at std 0.02, and the BN running
    stats are drawn too, so the eval BN is not the identity."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == 'relative_position_bias_table':
            v = rng.randn(*shape) * 0.02
        elif name in ('scale', 'var'):
            v = rng.uniform(0.8, 1.2, shape)
        else:   # bias, mean
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(shapes[c]))
            for c in ('params', 'batch_stats') if c in shapes}


@pytest.fixture(scope='module')
def models():
    """(JAX segmentor, its variables, the port's model with them)."""
    jm = jax_build(_cfg())
    jm.variables = _random_variables(
        jm.net, jnp.zeros((1, SIZE, SIZE, 3)), train=False,
        method=EncoderDecoderNet.forward_heads)
    tm = build_segmentor(_cfg())
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    return jm, tm.to(memory_format=torch.channels_last)


def _img(n=2, seed=0):
    return np.random.RandomState(seed).rand(n, SIZE, SIZE, 3).astype(
        np.float32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_every_flax_leaf_maps_to_a_port_key(models):
    jm, tm = models
    sd = jax_to_torch_state(jm.variables)
    leaves = [p for c in ('params', 'batch_stats')
              for p in _leaves(jm.variables[c])]
    bn = sum(1 for p in _leaves(jm.variables['batch_stats'])
             if p[-1] == 'mean')
    # one key per leaf, plus num_batches_tracked per BN
    assert len(sd) == len(leaves) + bn
    assert sorted(sd) == sorted(tm.state_dict())
    for k in ('backbone.stem.0.weight',
              'backbone.stages.3.blocks.0.grid_transformer.attention.'
              'relative_position_bias_table',
              'backbone.stages.0.blocks.0.block_transformer.attention.'
              'qkv_mapping.weight',
              'decode_head.stages.2.upsample.deconv.weight',
              'decode_head.stages.0.blocks.0.mb_conv.skip_conv.weight'):
        assert sd[k].shape == tm.state_dict()[k].shape, k


def test_deconv_module_matches_jax_and_needs_the_flip():
    """flax's ConvTranspose (VALID, then a crop of 1 each side) against
    torch's ConvTranspose2d(padding=1), in eval. The bridge flips the
    kernel in both spatial axes; unflipped, every shape matches and the
    output does not."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    jmod = JDeconv(out_channels=4)
    v = _random_variables(jmod, jnp.asarray(x), seed=1)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    tmod = DeconvModule(3, 4).eval()
    sd = jax_to_torch_state(v)
    tmod.load_state_dict(sd, strict=True)
    out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    unflipped = torch.from_numpy(np.ascontiguousarray(np.transpose(
        v['params']['deconv']['kernel'], (2, 3, 0, 1))))
    tmod.deconv.weight.data.copy_(unflipped)
    wrong = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert np.abs(wrong.detach().numpy() - ref).max() > 1e-2


@pytest.mark.parametrize('in_ch,out_ch,downscale', [(4, 8, True),
                                                    (16, 8, False)])
def test_maxvit_block_eval_matches_jax(in_ch, out_ch, downscale):
    """One MaxViTBlock in eval: an encoder block (downscales, maxpool +
    1×1 skip) and a decoder block (1×1 channel-matching skip)."""
    x = np.random.RandomState(2).randn(2, 8, 8, in_ch).astype(np.float32)
    kw = dict(downscale=downscale, num_heads=2, grid_window_size=(2, 2),
              mlp_ratio=2.0)
    jmod = JBlock(out_ch, **kw)
    v = _random_variables(jmod, jnp.asarray(x), seed=3)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    tmod = MaxViTBlock(in_ch, out_ch, **kw).eval()
    tmod.load_state_dict(jax_to_torch_state(v), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        out = tmod(xt).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_whole_logits_match_jax(models):
    jm, tm = models
    img = _img()
    ref = np.asarray(jm.encode_decode(img))
    before = twa.window_attention.launches
    out = tm.encode_decode(img)
    assert out.shape == (2, SIZE, SIZE, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    # the entry point: simple_test's argmax of the softmax
    metas = [dict(ori_shape=(SIZE, SIZE, 3), img_shape=(SIZE, SIZE, 3),
                  pad_shape=(SIZE, SIZE, 3), flip=False)] * 2
    preds = tm(return_loss=False, img=[img], img_metas=[metas])
    agree = np.mean(np.asarray(preds) == ref.argmax(-1))
    assert agree >= 0.999, agree
    assert twa.window_attention.launches == before


def test_bf16_image_follows_the_jax_dtype_flow(models):
    """In eval every layer follows the activations' dtype (Dense, Conv and
    LayerNorm take ``dtype=x.dtype``; BN casts back), so a bf16 image keeps
    every feature level in bf16 on both sides; the JAX side's dtypes come
    from ``jax.eval_shape``. In training the port stays in bf16 where
    JAX's DropPath promotes to f32 (ROADMAP.md §3)."""
    jm, tm = models
    img = _img(n=1, seed=2)
    jfeats, jout = jax.eval_shape(lambda x_: (
        jm.net.apply(jm.variables, x_, method=EncoderDecoderNet.extract),
        jm.net.apply(jm.variables, x_)),
        jax.ShapeDtypeStruct(img.shape, jnp.bfloat16))
    jf = [str(f.dtype) for f in jfeats]
    tf = [str(f.dtype).replace('torch.', '') for f in
          tm.extract_feat(torch.from_numpy(img).bfloat16())]
    assert jf == tf == ['bfloat16'] * 4
    tout = tm.encode_decode(torch.from_numpy(img).bfloat16())
    assert str(jout.dtype) == str(tout.dtype).replace('torch.', '')
    assert bool(torch.isfinite(tout.float()).all())
    tm.train()
    try:
        feats = tm.backbone(torch.from_numpy(img).bfloat16().permute(
            0, 3, 1, 2), torch.Generator().manual_seed(0))
    finally:
        tm.eval()
    assert [f.dtype for f in feats] == [torch.bfloat16] * 4


def test_train_steps_match_jax(models):
    """3 Adam steps (poly lr) of make_train_step against JAX's, with every
    dropout and drop-path rate at 0."""
    jm0, _ = models
    cfg = _cfg(rate=0.0)
    jm = jax_build(cfg)
    variables = jm0.variables
    rng = np.random.RandomState(3)
    img = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(2, SIZE, SIZE) < 0.1] = 255
    ocfg = dict(type='Adam', lr=ADAM_LR, betas=(0.9, 0.999))
    lr_config = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)
    tx = build_optimizer_tx(ocfg, jax_schedule(lr_config, ocfg['lr'], 10))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    jstep = jax_train_step(jm, tx, donate=False)
    tm = build_segmentor(cfg)
    tm.load_state_dict(jax_to_torch_state(variables), strict=True)
    tm = tm.to(memory_format=torch.channels_last)
    step = make_train_step(tm, build_optimizer(tm, ocfg),
                           build_lr_schedule(lr_config, ocfg['lr'], 10))
    p0 = {k: p.detach().clone() for k, p in tm.named_parameters()}
    for i in range(STEPS):
        state, jlogs = jstep(state, img, gt, jax.random.PRNGKey(0))
        logs = step(img, gt, torch.Generator().manual_seed(i))
        assert sorted(logs) == sorted(jlogs)
        for k in jlogs:
            np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                       rtol=1e-5, err_msg=k)
        if i == 0:
            g1 = {k: p.grad.clone() for k, p in tm.named_parameters()}
            moves1 = _moves(tm, p0, state.variables)
    ref = jax_to_torch_state(_np(state.variables))
    sd = tm.state_dict()
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=0, atol=2 * STEPS * ADAM_LR,
                                   err_msg=k)
    for k in ref:
        if k.endswith('num_batches_tracked'):
            assert int(sd[k]) == STEPS, k
    # Where the first gradient is at least 1e-3 of the largest (70 % of the
    # coordinates here), Adam's moves must agree: to lr/1000 after step 1
    # (one f32 ulp of the parameter, 1.2e-7 seen) and to 0.2·lr after 3
    # steps (0.009·lr seen).
    scale = max(g.abs().max().item() for g in g1.values())
    _assert_moves_close(moves1, g1, 1e-3 * scale, atol=1e-3 * ADAM_LR)
    _assert_moves_close(_moves(tm, p0, state.variables), g1, 1e-3 * scale,
                        atol=0.2 * ADAM_LR)


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


def test_drop_path_one_keep_per_window_in_attention_per_image_in_mbconv():
    """drop_path draws one keep per row of its input's first axis. Inside
    the transformer blocks that axis is the partition (B · windows or grid
    cells); in MBConv it is the batch."""
    x = torch.ones(64, 4, 3)
    y = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    per_row = y[:, 0, 0]
    assert torch.equal(y, per_row[:, None, None].expand_as(y))
    assert set(per_row.tolist()) == {0.0, 2.0}
    assert torch.equal(y, drop_path(x, 0.5, torch.Generator().manual_seed(0)))
    assert DropPath(0.5).eval()(x) is x

    block = MaxViTBlock(4, 8, downscale=True, num_heads=2,
                        grid_window_size=(2, 2), drop_path=0.5).train()
    rows = {}
    for name, m in block.named_modules():
        if isinstance(m, DropPath):
            m.register_forward_hook(
                lambda mod, args, out, name=name: rows.setdefault(
                    name, args[0].shape[0]))
    block(torch.randn(3, 4, 8, 8), torch.Generator().manual_seed(1))
    cells = 3 * (4 // 2) * (4 // 2)   # B=3 at 4x4 after the downscale
    assert rows == {'mb_conv.drop_path': 3,
                    'block_transformer.dp1': cells,
                    'block_transformer.dp2': cells,
                    'grid_transformer.dp1': cells,
                    'grid_transformer.dp2': cells}


def test_transform_inputs_match_jax():
    """``resize_concat`` and ``multiple_select`` against the JAX head's
    (the port's heads take NCHW levels, JAX's NHWC)."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, c).astype(np.float32)
             for s, c in ((8, 3), (4, 5), (2, 6))]
    tfeats = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    for transform in ('resize_concat', 'multiple_select'):
        kw = dict(in_channels=[3, 5, 6], in_index=[0, 2, 1],
                  input_transform=transform)
        ref = JHead(**kw)._transform_inputs([jnp.asarray(f) for f in feats])
        out = BaseDecodeHead(**kw)._transform_inputs(tfeats)
        if transform == 'resize_concat':
            np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(ref), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert [o.shape[1] for o in out] == [3, 6, 5]
            for o, r in zip(out, ref):
                np.testing.assert_array_equal(o.permute(0, 2, 3, 1).numpy(),
                                              np.asarray(r))
    with pytest.raises(AssertionError, match='equal length'):
        BaseDecodeHead(in_channels=[3, 5], in_index=[0],
                       input_transform='multiple_select')


def test_full_width_config_builds_and_with_cp_raises():
    """``my_config/MaxViT-UNet.py`` builds at full width (its depths, 32
    heads, 8×8 windows); the seeded init draws the relative-position tables
    from a normal of std 0.02 cut at 2 std; a remat mode raises in
    training, not in eval."""
    from stc_unet_tpu_torch.utils import Config
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'MaxViT-UNet.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert not m.training and m.out_channels == 2
    assert [len(s.blocks) for s in m.backbone.stages] == [2, 2, 2, 2]
    assert [len(s.blocks) for s in m.decode_head.stages] == [2, 2, 2]
    attn = m.backbone.stages[3].blocks[1].grid_transformer.attention
    assert attn.qkv_mapping.weight.shape == (1536, 512)
    assert attn.relative_position_bias_table.shape == (225, 32)
    assert m.decode_head.stages[0].upsample.deconv.weight.shape == \
        (512, 256, 4, 4)
    table = build_segmentor(_cfg()).init_weights().backbone.stages[0].blocks[
        0].block_transformer.attention.relative_position_bias_table
    assert 0 < table.abs().max() <= 0.04 and table.std() > 0.01
    block = MaxViTBlock(4, 4, num_heads=2, grid_window_size=(2, 2))
    x = torch.randn(1, 4, 4, 4)
    assert apply_maxvit_block(block.eval(), x, 'attn').shape == x.shape
    with pytest.raises(NotImplementedError, match='BN running stats'):
        apply_maxvit_block(block.train(), x, True)
