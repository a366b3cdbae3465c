"""The necks (FPN, JPU, MultiLevelNeck, Feature2Pyramid, MLANeck), FPNHead
and the ViT backbone against the JAX package, on the CPU.

Each module at tiny widths on small random NHWC inputs drawn with numpy,
in eval and in training (BN running stats too); FPN in every
``add_extra_convs`` mode and with ``start_level``/``end_level``, JPU with
both, MultiLevelNeck on one input and on four, Feature2Pyramid at all
five rescales, MLANeck's top-first order and its LayerNorm eps; FPNHead
and its ``scale_heads`` keys; the ViT at a square input and at a
non-square one that is no multiple of the patch (padding and the bicubic
position grid), with ``final_norm``, ``output_cls_token``, negative
``out_indices`` and its refusals. JAX variables are drawn with numpy
(``tests/fixtures/torch_port.py``) and carried by ``jax_to_torch_state``
with ``strict=True``; every flax leaf is also carried back, bit for bit.

Tolerances, f32, as ``tests/test_torch_swin_upernet.py`` holds the Swin
backbone and the heads: rtol 1e-5 / atol 1e-5 (BN in training also its
running stats); the bicubic resize at rtol 1e-5 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models import build_head as jax_head
from stc_unet_tpu.models.backbones.vit import \
    VisionTransformer as JaxVisionTransformer
from stc_unet_tpu.models.builder import NECKS as JAX_NECKS
from stc_unet_tpu.ops import resize as jax_resize
from stc_unet_tpu_torch.models import build_head, build_neck
from stc_unet_tpu_torch.models.backbones.vit import VisionTransformer
from stc_unet_tpu_torch.ops import resize
from stc_unet_tpu_torch.utils import jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401
from tests.test_torch_psp_aspp import check_stats, load, nchw, nhwc, rand

LEVELS = [(2, 16, 16, 4), (2, 8, 8, 8), (2, 4, 4, 16), (2, 2, 2, 32)]
BN = dict(type='BN')


def apply_jax(module, inputs, train=False):
    """``module`` (flax) with numpy-drawn variables on the NHWC levels
    ``inputs``: (output, variables, updated batch stats, None without
    BN or in eval)."""
    v = random_variables(module, [jnp.asarray(x) for x in inputs], seed=1)
    if not train:
        return jax.jit(module.apply)(v, inputs), v, None
    out, upd = jax.jit(lambda v_, x_: module.apply(
        v_, x_, train=True, mutable=['batch_stats']))(v, inputs)
    return out, v, upd.get('batch_stats')


def run_pair(jmod, tmod, inputs, train=False):
    """The JAX module and the port's on the same NHWC ``inputs`` (a list
    of levels): the outputs held, the leaves round-tripped, the BN stats
    in training; returns the port's outputs (NHWC numpy)."""
    ref, v, upd = apply_jax(jmod, inputs, train=train)
    tmod = load(tmod, v).train(train)
    mono.check_round_trip(v, tmod)
    with torch.no_grad():
        outs = tmod([nchw(x) for x in inputs])
    assert len(outs) == len(ref)
    got = [nhwc(o) for o in outs]
    for o, r in zip(got, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-5, atol=1e-5)
    if upd is not None:
        check_stats(tmod, upd)
    return got


def neck_pair(cfg):
    cfg = dict(cfg)
    jax_cfg = {k: tuple(v) if isinstance(v, list) else v
               for k, v in cfg.items()}
    return JAX_NECKS.build(jax_cfg), build_neck(cfg)


# -- FPN ----------------------------------------------------------------------

FPNS = {
    'pools': dict(num_outs=6),
    'extra-true-on-output': dict(num_outs=6, add_extra_convs=True),
    'extra-true-on-inputs': dict(num_outs=6, add_extra_convs=True,
                                 extra_convs_on_inputs=True),
    'on_input': dict(num_outs=5, add_extra_convs='on_input'),
    'on_lateral': dict(num_outs=6, add_extra_convs='on_lateral',
                       relu_before_extra_convs=True),
    'on_output-relu': dict(num_outs=6, add_extra_convs='on_output',
                           relu_before_extra_convs=True),
    'levels-1-3': dict(num_outs=4, start_level=1, end_level=3,
                       add_extra_convs='on_input'),
    'bn-no-lateral-norm': dict(num_outs=4, norm_cfg=BN,
                               no_norm_on_lateral=True,
                               act_cfg=dict(type='ReLU')),
    'bilinear': dict(num_outs=4, norm_cfg=BN,
                     upsample_cfg=dict(mode='bilinear',
                                       align_corners=False)),
}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', list(FPNS))
def test_fpn_matches_jax(name, train):
    cfg = dict(type='FPN', in_channels=[4, 8, 16, 32], out_channels=8,
               **FPNS[name])
    inputs = [rand(*s, seed=i) for i, s in enumerate(LEVELS)]
    jmod, tmod = neck_pair(cfg)
    outs = run_pair(jmod, tmod, inputs, train)
    assert len(outs) == len(tmod.out_channels) == max(
        cfg['num_outs'], len(tmod.used))


def test_fpn_keys_are_mmsegs():
    """The extra convs follow the level convs in ``fpn_convs``, the first
    on the last used input's width with ``'on_input'``."""
    neck = build_neck(dict(type='FPN', in_channels=[4, 8, 16, 32],
                           out_channels=8, num_outs=6,
                           add_extra_convs='on_input'))
    keys = set(neck.state_dict())
    assert {'lateral_convs.3.conv.weight', 'fpn_convs.3.conv.bias',
            'fpn_convs.4.conv.weight', 'fpn_convs.5.conv.weight'} <= keys
    assert neck.fpn_convs[4].conv.in_channels == 32
    assert neck.fpn_convs[5].conv.in_channels == 8
    assert not any('extra' in k for k in keys)
    with pytest.raises(NotImplementedError, match='invalid add_extra'):
        build_neck(dict(type='FPN', in_channels=[4, 8], out_channels=8,
                        num_outs=3, add_extra_convs='on_nothing'))
    with pytest.raises(AssertionError, match="backbone's widths"):
        build_neck(dict(type='FPN', in_channels=[4, 8], out_channels=8),
                   default_args=dict(feature_channels=[4, 16]))


# -- JPU ---------------------------------------------------------------------

JPU_LEVELS = [(2, 8, 8, 4), (2, 4, 4, 8), (2, 2, 2, 16)]


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('levels', [(0, -1), (1, -1), (0, 2)])
def test_jpu_matches_jax(levels, train):
    """The fused map at the first used level's size, after
    ``inputs[start:end - 1]`` passed through (not ``inputs[:-1]``)."""
    start, end = levels
    cfg = dict(type='JPU', in_channels=[4, 8, 16], mid_channels=4,
               start_level=start, end_level=end, dilations=[1, 2, 3],
               align_corners=False)
    inputs = [rand(*s, seed=i) for i, s in enumerate(JPU_LEVELS)]
    jmod, tmod = neck_pair(cfg)
    outs = run_pair(jmod, tmod, inputs, train)
    stop = 3 if end == -1 else end
    assert len(outs) == stop - start
    for got, x in zip(outs[:-1], inputs[start:stop - 1]):
        np.testing.assert_array_equal(got, x)
    assert outs[-1].shape == (2,) + JPU_LEVELS[start][1:3] + (12,)
    assert tmod.out_channels == [4, 8, 16][start:stop - 1] + [12]


def test_jpu_keys_and_checks():
    neck = build_neck(dict(type='JPU', in_channels=[4, 8, 16],
                           mid_channels=4, dilations=[1, 2]))
    keys = set(neck.state_dict())
    assert {'conv_layers.2.0.conv.weight', 'conv_layers.0.0.bn.running_var',
            'dilation_layers.1.0.depthwise_conv.conv.weight',
            'dilation_layers.1.0.depthwise_conv.bn.weight',
            'dilation_layers.0.0.pointwise_conv.bn.bias'} <= keys
    assert neck.dilation_layers[1][0].depthwise_conv.act is None
    for kw, match in ((dict(in_channels=4), 'in_channels must be'),
                      (dict(dilations=2), 'dilations must be'),
                      (dict(end_level=4), 'exceeds the number')):
        cfg = dict(dict(type='JPU', in_channels=[4, 8, 16]), **kw)
        with pytest.raises(AssertionError, match=match):
            JAX_NECKS.build(cfg)
        with pytest.raises(AssertionError, match=match):
            build_neck(cfg)


# -- MultiLevelNeck, Feature2Pyramid, MLANeck --------------------------------

@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', ['one-input', 'four-inputs', 'bn-relu'])
def test_multilevel_neck_matches_jax(case, train):
    """One 6x6 input rescaled to 3, 6, 12 and 24 (a 0.5 of an odd side
    too: 5x7 → 2x3); four inputs, one a scale."""
    if case == 'one-input':
        cfg = dict(type='MultiLevelNeck', in_channels=[8], out_channels=4,
                   scales=[0.5, 1, 2, 4])
        inputs = [rand(2, 5, 7, 8)]
    else:
        cfg = dict(type='MultiLevelNeck', in_channels=[8] * 4,
                   out_channels=4, scales=[4, 2, 1, 0.5])
        if case == 'bn-relu':
            cfg.update(norm_cfg=BN, act_cfg=dict(type='ReLU'))
        inputs = [rand(2, 6, 6, 8, seed=i) for i in range(4)]
    jmod, tmod = neck_pair(cfg)
    outs = run_pair(jmod, tmod, inputs, train)
    want = [(2, 2, 3), (5, 7), (10, 14), (20, 28)] if case == 'one-input' \
        else [(24, 24), (12, 12), (6, 6), (3, 3)]
    assert [o.shape[1:3] for o in outs] == [w[-2:] for w in want]
    keys = set(tmod.state_dict())
    assert {'lateral_convs.0.conv.weight', 'convs.3.conv.weight'} <= keys


@pytest.mark.parametrize('train', [False, True])
def test_feature2pyramid_matches_jax(train):
    """All five rescales: the transposed convs (bare flax kernels,
    flipped by the bridge), BN and exact GELU, identity, both pools."""
    cfg = dict(type='Feature2Pyramid', embed_dim=4,
               rescales=[4, 2, 1, 0.5, 0.25])
    inputs = [rand(2, 8, 8, 4, seed=i) for i in range(5)]
    jmod, tmod = neck_pair(cfg)
    outs = run_pair(jmod, tmod, inputs, train)
    assert [o.shape[1] for o in outs] == [32, 16, 8, 4, 2]
    assert {'upsample_4x.0.weight', 'upsample_4x.1.running_mean',
            'upsample_4x.3.bias', 'upsample_2x.0.weight'} <= set(
                tmod.state_dict())


def test_feature2pyramid_checks():
    for rescales in ([4, 3], [1.5]):
        cfg = dict(type='Feature2Pyramid', embed_dim=4, rescales=rescales)
        with pytest.raises(KeyError, match='invalid'):
            JAX_NECKS.build(dict(cfg, rescales=tuple(rescales)))
        with pytest.raises(KeyError, match='invalid'):
            build_neck(cfg)
    with pytest.raises(ValueError, match='twice'):
        build_neck(dict(type='Feature2Pyramid', embed_dim=4,
                        rescales=[4, 4]))
    with pytest.raises(NotImplementedError, match='norm_cfg'):
        build_neck(dict(type='Feature2Pyramid', embed_dim=4,
                        norm_cfg=dict(type='GN', num_groups=2)))
    with pytest.raises(AssertionError, match="backbone's widths"):
        build_neck(dict(type='Feature2Pyramid', embed_dim=4,
                        rescales=[2, 1]),
                   default_args=dict(feature_channels=[4, 8]))


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('norm', [None, BN])
def test_mla_neck_matches_jax(norm, train):
    """The LayerNorms at eps 1e-6 (on inputs of variance near 1e-6, where
    torch's default 1e-5 would move them by 40 %), the top level's output
    first: output 0 is a function of the top input alone."""
    cfg = dict(type='MLANeck', in_channels=[4, 6, 8], out_channels=4,
               norm_cfg=norm)
    inputs = [rand(2, 5, 5, c, seed=i) * 1e-3 for i, c in
              enumerate([4, 6, 8])]
    jmod, tmod = neck_pair(cfg)
    outs = run_pair(jmod, tmod, inputs, train)
    assert all(n.eps == 1e-6 for n in tmod.norm)
    if not train:
        changed = [x.copy() for x in inputs]
        changed[0] += 1.0
        changed[1] *= 3.0
        with torch.no_grad():
            again = tmod([nchw(x) for x in changed])
        np.testing.assert_array_equal(nhwc(again[0]), outs[0])
        assert not np.allclose(nhwc(again[2]), outs[2])
    keys = set(tmod.state_dict())
    assert {'norm.2.weight', 'mla.channel_proj.1.conv.weight',
            'mla.feat_extract.2.conv.weight'} <= keys


# -- FPNHead -----------------------------------------------------------------

@pytest.mark.parametrize('train', [False, True])
def test_fpn_head_matches_jax(train):
    cfg = dict(type='FPNHead', in_channels=[4, 4, 4, 4],
               in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
               channels=8, num_classes=3, norm_cfg=BN, dropout_ratio=0.0)
    inputs = [rand(2, s, s, 4, seed=i) for i, s in enumerate([16, 8, 4, 2])]
    ref, v, upd = apply_jax(jax_head(cfg), inputs, train=train)
    head = load(build_head(cfg), v).train(train)
    mono.check_round_trip(v, head)
    with torch.no_grad():
        out = head([nchw(x) for x in inputs])
    assert out.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if upd is not None:
        check_stats(head, upd)


def test_fpn_head_scale_heads_are_mmsegs():
    """Level 0: one conv at 0; level i > 0: i convs at 0, 2, 4 with an
    upsample after each."""
    head = build_head(dict(type='FPNHead', in_channels=[4, 4, 4, 4],
                           in_index=[0, 1, 2, 3],
                           feature_strides=[4, 8, 16, 32], channels=8,
                           num_classes=3, norm_cfg=BN))
    keys = set(head.state_dict())
    assert {'scale_heads.0.0.conv.weight', 'scale_heads.1.0.bn.weight',
            'scale_heads.2.2.conv.weight', 'scale_heads.3.4.conv.weight',
            'conv_seg.weight'} <= keys
    assert [len(s) for s in head.scale_heads] == [1, 2, 4, 6]
    assert not any(k.startswith(('scale_heads.0.1', 'scale_heads.3.1.',
                                 'scale_heads.3.3.')) for k in keys)


# -- the ViT backbone --------------------------------------------------------

VIT = dict(img_size=64, patch_size=16, embed_dims=16, num_layers=3,
           num_heads=2, mlp_ratio=2.0, out_indices=(0, 2),
           norm_cfg=dict(type='LN', eps=1e-6))


def vit_pair(x, **kw):
    cfg = dict(VIT, **kw)
    jmod = JaxVisionTransformer(**cfg)
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    ref = jax.jit(jmod.apply)(v, jnp.asarray(x))
    mod = VisionTransformer(**cfg)
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    mono.check_round_trip(v, mod)
    return ref, mod


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', ['square', 'padded-bicubic', 'final-norm',
                                  'negative-indices', 'no-cls'])
def test_vit_matches_jax(case, train):
    """64² (the 4x4 position grid as it is); 70x45, padded to 80x48, 5x3
    tokens on the 4x4 grid resized bicubically; ``final_norm`` (the
    fork's ``ln1``); ``out_indices`` (-1, 1); no cls token."""
    kw = {'final-norm': dict(final_norm=True),
          'negative-indices': dict(out_indices=(-1, 1)),
          'no-cls': dict(with_cls_token=False)}.get(case, {})
    hw = (70, 45) if case == 'padded-bicubic' else (64, 64)
    x = rand(2, *hw, 3, seed=hw[1])
    ref, mod = vit_pair(x, **kw)
    mod.train(train)
    with torch.no_grad():
        outs = mod(nchw(x))
    assert len(outs) == len(ref) == 2
    side = (5, 3) if case == 'padded-bicubic' else (4, 4)
    for out, r in zip(outs, ref):
        assert nhwc(out).shape == (2,) + side + (16,)
        np.testing.assert_allclose(nhwc(out), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_vit_output_cls_token_matches_jax():
    x = rand(2, 64, 64, 3)
    ref, mod = vit_pair(x, output_cls_token=True)
    with torch.no_grad():
        outs = mod.eval()(nchw(x))
    for (feat, cls), (rf, rc) in zip(outs, ref):
        np.testing.assert_allclose(nhwc(feat), np.asarray(rf), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(cls.numpy(), np.asarray(rc), rtol=1e-5,
                                   atol=1e-5)


def test_bicubic_position_grid_resize_matches_jax():
    """The position grid's resize alone, at ADE20K's whole-test shape: a
    32x32 grid to the 32x43 tokens of a 512x683 image, and a 4x4 grid up
    and down; standard normal values (up to 4.4 here; a position
    embedding's are at std 0.02)."""
    for shape, size in (((1, 32, 32, 16), (32, 43)), ((1, 4, 4, 3), (5, 3)),
                        ((1, 4, 4, 3), (2, 7))):
        g = rand(*shape, seed=size[1])
        ref = np.asarray(jax_resize(jnp.asarray(g), size=size,
                                    mode='bicubic', align_corners=False))
        out = resize(torch.from_numpy(g), size=size, mode='bicubic',
                     align_corners=False).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_vit_keys_are_the_forks():
    mod = VisionTransformer(**dict(VIT, final_norm=True))
    keys = set(mod.state_dict())
    assert {'patch_embed.projection.weight', 'cls_token', 'pos_embed',
            'layers.0.ln1.weight', 'layers.0.attn.attn.in_proj_weight',
            'layers.0.attn.attn.in_proj_bias',
            'layers.0.attn.attn.out_proj.weight', 'layers.2.ln2.bias',
            'layers.1.ffn.layers.0.0.weight', 'layers.1.ffn.layers.1.bias',
            'ln1.weight'} <= keys
    assert mod.pos_embed.shape == (1, 17, 16)
    assert mod.layers[0].ln1.eps == 1e-6
    rates = [m.attn.dropout_layer.rate for m in VisionTransformer(
        **dict(VIT, drop_path_rate=0.2)).layers]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 3))


def test_vit_refusals_and_checks():
    for kw, err in ((dict(patch_norm=True), 'patch_norm'),
                    (dict(pre_norm=True), 'pre_norm'),
                    (dict(num_fcs=3), 'num_fcs'),
                    (dict(patch_pad='same'), 'patch_pad'),
                    (dict(act_cfg=dict(type='ReLU')), 'act_cfg'),
                    (dict(norm_cfg=dict(type='BN')), 'norm_cfg'),
                    (dict(img_size=(64, 32)), 'img_size'),
                    (dict(pretrained='vit.pth'), 'pretrained'),
                    (dict(init_cfg=dict(type='Pretrained',
                                        checkpoint='vit.pth')),
                     'pretrained')):
        with pytest.raises(NotImplementedError, match=err):
            VisionTransformer(**dict(VIT, **kw))
    with pytest.raises(AssertionError, match='with_cls_token'):
        VisionTransformer(**dict(VIT, with_cls_token=False,
                                 output_cls_token=True))
    with pytest.raises(TypeError, match='img_size'):
        VisionTransformer(**dict(VIT, img_size=64.0))
    with pytest.raises(TypeError, match='out_indices'):
        VisionTransformer(**dict(VIT, out_indices='0'))
    with pytest.raises(TypeError, match='str path'):
        VisionTransformer(**dict(VIT, pretrained=3))
    # a square tuple is the JAX module's side
    assert VisionTransformer(**dict(VIT, img_size=(64, 64))).side == 4
    # an int out_indices is one index: -1 and 11 of 12 layers (and the
    # default, mmseg's -1) give the last layer's map alone
    x = torch.from_numpy(rand(1, 64, 64, 3, seed=9)).permute(0, 3, 1, 2)
    deep = {k: v for k, v in VIT.items() if k != 'out_indices'}
    deep['num_layers'] = 12
    mod = VisionTransformer(**dict(deep, out_indices=(0, 11))).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        last = mod(x)[1]
        for kw in (dict(out_indices=-1), dict(out_indices=11), {}):
            one = VisionTransformer(**dict(deep, **kw)).eval()
            one.load_state_dict(mod.state_dict())
            outs = one(x)
            assert one.out_indices == (11,) and one.out_channels == [16]
            assert len(outs) == 1
            torch.testing.assert_close(outs[0], last, rtol=0, atol=0)
