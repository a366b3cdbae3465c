"""The ViT's heads (SETRUPHead, SETRMLAHead, SegmenterMaskTransformerHead,
DPTHead with ReassembleBlocks, FeatureFusionBlock and
PreActResidualConvUnit) and the ViT backbone's ``out_indices`` against the
JAX package, on the CPU.

Each head alone at tiny widths on random NHWC levels drawn with numpy
(DPT's as ``(map, cls_token)`` pairs, as the ViT gives them under
``output_cls_token``), in eval and in training (BN running stats too):
SETRUPHead at kernel 1 and 3, SETRMLAHead on 2 and 4 levels, the
Segmenter head, DPTHead in each readout and with ``expand_channels``;
their mmseg keys and construction checks; the ViT's default
``out_indices`` (-1, mmseg's) and an int, the stock Segmenter's layer 11
through ``final_norm`` against JAX built at ``(11,)``. JAX variables are
drawn with numpy (``tests/fixtures/torch_port.py``) and carried by
``jax_to_torch_state`` with ``strict=True``; every flax leaf is also
carried back, bit for bit.

Tolerances, f32, as ``tests/test_torch_necks.py`` holds the necks: rtol
1e-5 / atol 1e-5 (BN in training also its running stats). The Segmenter
head's masks (L2-normalised projections, their products and a LayerNorm
over the classes) are held at the same 1e-5: tighter than the 5e-4 the
JAX package's own oracle allows them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models import build_head as jax_head
from stc_unet_tpu.models.backbones.vit import \
    VisionTransformer as JaxVisionTransformer
from stc_unet_tpu_torch.models import build_head
from stc_unet_tpu_torch.models.backbones.vit import VisionTransformer
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401
from tests.test_torch_psp_aspp import check_stats, load, nchw, nhwc, rand

BN = dict(type='BN')
LEVEL = (2, 4, 4, 16)     # a ViT's token map: 4x4 tokens, 16 wide
TOL = dict(rtol=1e-5, atol=1e-5)


def levels(n=4, cls=False):
    """``n`` NHWC token maps (with their cls tokens as pairs)."""
    maps = [rand(*LEVEL, seed=i) for i in range(n)]
    if not cls:
        return maps
    return [(m, rand(LEVEL[0], LEVEL[3], seed=10 + i))
            for i, m in enumerate(maps)]


def to_port(x):
    return tuple(to_port(t) for t in x) if isinstance(x, tuple) else (
        nchw(x) if x.ndim == 4 else torch.from_numpy(x))


def head_pair(cfg, inputs, train=False):
    """The JAX head and the port's built from ``cfg`` on the same levels:
    the outputs held, the leaves round-tripped, the BN stats in training;
    returns (port head, its NHWC output)."""
    jcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    jmod = jax_head(jcfg)
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    v = random_variables(jmod, jin, seed=1)
    if train:
        ref, upd = jax.jit(lambda v_, x_: jmod.apply(
            v_, x_, train=True, mutable=['batch_stats']))(v, jin)
        upd = upd.get('batch_stats')
    else:
        ref, upd = jax.jit(jmod.apply)(v, jin), None
    tmod = load(build_head(dict(cfg)), v).train(train)
    mono.check_round_trip(v, tmod)
    with torch.no_grad():
        out = nhwc(tmod([to_port(x) for x in inputs]))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    if upd:
        check_stats(tmod, upd)
    return tmod, out


def setr_up(kernel_size, num_convs, up_scale, **kw):
    return dict(dict(type='SETRUPHead', in_channels=16, channels=8,
                     in_index=3, num_classes=3, dropout_ratio=0,
                     norm_cfg=BN, num_convs=num_convs, up_scale=up_scale,
                     kernel_size=kernel_size), **kw)


def setr_mla(n):
    return dict(type='SETRMLAHead', in_channels=[16] * n, channels=4 * n,
                in_index=list(range(n)), mla_channels=4, num_classes=3,
                dropout_ratio=0, norm_cfg=BN)


def segmenter(**kw):
    return dict(dict(type='SegmenterMaskTransformerHead', in_channels=16,
                     channels=16, num_classes=3, num_layers=2, num_heads=2,
                     embed_dims=16, dropout_ratio=0.0), **kw)


def dpt(readout, expand=False):
    return dict(type='DPTHead', in_channels=[16] * 4, channels=8,
                embed_dims=16, post_process_channels=[2, 4, 4, 8],
                num_classes=3, readout_type=readout,
                input_transform='multiple_select', in_index=[0, 1, 2, 3],
                norm_cfg=BN, expand_channels=expand, dropout_ratio=0)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', ['naive-k1', 'pup-k3', 'pup-k3-corners'])
def test_setr_up_head_matches_jax(case, train):
    """Kernel 1, one conv, x4 (SETR-naive); kernel 3, two convs, x2 (the
    PUP's progressive upsampling), also with ``align_corners``."""
    cfg = {'naive-k1': setr_up(1, 1, 4),
           'pup-k3': setr_up(3, 2, 2),
           'pup-k3-corners': setr_up(3, 2, 2, align_corners=True)}[case]
    _, out = head_pair(cfg, levels(), train)
    up = cfg['up_scale'] ** cfg['num_convs']
    assert out.shape == (2, 4 * up, 4 * up, 3)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('n', [2, 4])
def test_setr_mla_head_matches_jax(n, train):
    _, out = head_pair(setr_mla(n), levels(n), train)
    assert out.shape == (2, 16, 16, 3)


@pytest.mark.parametrize('train', [False, True])
def test_segmenter_head_matches_jax(train):
    """Eval at the default drop-path rate (0.1, off in eval), training at
    0 (the two frameworks' random draws cannot match); masks (N, K, h, w)
    at the token grid."""
    cfg = segmenter(drop_path_rate=0.0) if train else segmenter()
    tmod, out = head_pair(cfg, levels(1), train)
    assert out.shape == (2, 4, 4, 3)
    assert not hasattr(tmod, 'conv_seg')


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', ['ignore', 'add', 'project',
                                  'project-expand', 'no-cls'])
def test_dpt_head_matches_jax(case, train):
    """Each readout on ``(map, cls)`` pairs, ``expand_channels`` (levels
    at 2, 8, 16, 64), and plain maps (no cls token: nothing to read out,
    and JAX builds no readout Linear, which mmseg's layout holds for
    ``'project'`` whatever the inputs)."""
    readout = case.split('-')[0] if case != 'no-cls' else 'ignore'
    cfg = dpt(readout, expand=case.endswith('expand'))
    tmod, out = head_pair(cfg, levels(cls=case != 'no-cls'), train)
    # strides 4, 8, 16, 32 of a stride-16 map fused up to stride 2
    assert out.shape == (2, 32, 32, 3)
    widths = [m.conv.out_channels for m in tmod.reassemble_blocks.projects]
    assert widths == ([2, 8, 16, 64] if case.endswith('expand')
                      else [2, 4, 4, 8])


def test_dpt_fusion_resizes_a_mismatched_skip():
    """A skip whose size is not the upsampled map's is resized bilinearly
    (``align_corners=False``) before its residual unit: a 5x5 map over
    3x3 skips."""
    cfg = dpt('ignore')
    jcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    inputs = [rand(2, s, s, 16, seed=s) for s in (5, 5, 5, 3)]
    jmod = jax_head(jcfg)
    v = random_variables(jmod, [jnp.asarray(x) for x in inputs], seed=4)
    ref = jax.jit(jmod.apply)(v, inputs)
    tmod = load(build_head(cfg), v).eval()
    with torch.no_grad():
        out = nhwc(tmod([nchw(x) for x in inputs]))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_the_heads_keys_are_mmsegs():
    keys = {name: set(build_head(cfg).state_dict()) for name, cfg in (
        ('up', setr_up(3, 2, 2)), ('mla', setr_mla(4)),
        ('segmenter', segmenter()), ('dpt', dpt('project')))}
    assert {'norm.weight', 'up_convs.0.0.conv.weight',
            'up_convs.1.0.bn.running_var', 'conv_seg.weight'} <= keys['up']
    assert {'up_convs.3.0.conv.weight', 'up_convs.3.1.bn.weight',
            'conv_seg.bias'} <= keys['mla']
    assert {k for k in keys['segmenter'] if not k.startswith('layers.')} \
        == {'dec_proj.weight', 'dec_proj.bias', 'cls_emb',
            'decoder_norm.weight', 'decoder_norm.bias', 'patch_proj.weight',
            'classes_proj.weight', 'mask_norm.weight', 'mask_norm.bias'}
    assert {'layers.1.ln1.weight', 'layers.0.attn.attn.in_proj_weight',
            'layers.0.attn.attn.out_proj.bias', 'layers.1.ln2.bias',
            'layers.1.ffn.layers.0.0.weight'} <= keys['segmenter']
    assert not any(k.startswith('conv_seg') for k in keys['segmenter'])
    assert {'reassemble_blocks.projects.3.conv.weight',
            'reassemble_blocks.readout_projects.2.0.weight',
            'reassemble_blocks.resize_layers.0.weight',
            'reassemble_blocks.resize_layers.3.bias', 'convs.0.conv.weight',
            'fusion_blocks.1.res_conv_unit1.conv1.conv.weight',
            'fusion_blocks.3.res_conv_unit2.conv2.bn.running_mean',
            'fusion_blocks.0.project.conv.bias', 'project.conv.weight',
            'project.bn.weight'} <= keys['dpt']
    assert not any(k.startswith('fusion_blocks.0.res_conv_unit1')
                   for k in keys['dpt'])
    assert 'convs.0.conv.bias' not in keys['dpt']
    dpt_head = build_head(dpt('project'))
    assert isinstance(dpt_head.reassemble_blocks.resize_layers[0],
                      torch.nn.ConvTranspose2d)
    assert dpt_head.reassemble_blocks.resize_layers[0].stride == (4, 4)


@pytest.mark.parametrize('case', ['up-kernel', 'mla-channels', 'dpt-readout',
                                  'dpt-no-transform'])
def test_construction_checks_match_jax(case):
    """The JAX heads' checks, raised by both packages: SETRUPHead's kernel
    of 1 or 3, SETRMLAHead's ``channels == levels · mla_channels``, DPT's
    readout type, and DPT without ``input_transform`` (not defaulted:
    its four in_channels need one)."""
    cfg, match = {
        'up-kernel': (setr_up(5, 1, 4), 'kernel_size must be 1 or 3'),
        'mla-channels': (dict(setr_mla(4), channels=15),
                         r'channels \(15\) must equal'),
        'dpt-readout': (dpt('mean'), 'invalid readout_type'),
        'dpt-no-transform': ({k: v for k, v in dpt('ignore').items()
                              if k != 'input_transform'},
                             'in_channels must be an int'),
    }[case]
    with pytest.raises(AssertionError, match=match):
        build_head(dict(cfg))
    jcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    with pytest.raises(AssertionError, match=match):
        jax_head(jcfg)


# -- the ViT's out_indices ---------------------------------------------------

SEGMENTER_VIT = dict(img_size=64, patch_size=16, embed_dims=16,
                     num_layers=12, num_heads=2, final_norm=True,
                     norm_cfg=dict(type='LN', eps=1e-6))


@pytest.fixture(scope='module')
def segmenter_vit():
    """JAX's ViT of the stock Segmenter built at ``(11,)``, and at its own
    default indices, on one image: (image, variables, layer 11's map,
    the default's outputs)."""
    x = rand(2, 64, 64, 3, seed=5)
    jmod = JaxVisionTransformer(**dict(SEGMENTER_VIT, out_indices=(11,)))
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    ref = jax.jit(jmod.apply)(v, jnp.asarray(x))
    layer9 = jax.jit(JaxVisionTransformer(**SEGMENTER_VIT).apply)(
        v, jnp.asarray(x))
    return x, v, np.asarray(ref[0]), layer9


@pytest.mark.parametrize('out_indices', ['default', -1, 11, (11,)])
def test_segmenter_vit_reads_its_last_layer(segmenter_vit, out_indices):
    """The stock Segmenter's ViT (12 layers, ``final_norm``, no
    ``out_indices``) returns its last layer after ``final_norm``, as
    mmseg's default -1 says: against JAX built at ``(11,)``. JAX's own
    default (9, 14, 19, 23) reads layer 9 and leaves ``norm1_final``
    unused."""
    x, v, ref, layer9 = segmenter_vit
    kw = {} if out_indices == 'default' else dict(out_indices=out_indices)
    mod = load(VisionTransformer(**dict(SEGMENTER_VIT, **kw)), v).eval()
    mono.check_round_trip(v, mod)
    assert mod.out_indices == (11,) and mod.out_channels == [16]
    with torch.no_grad():
        outs = mod(nchw(x))
    assert len(outs) == 1
    np.testing.assert_allclose(nhwc(outs[0]), ref, **TOL)
    # the JAX default reads layer 9: another map
    assert len(layer9) == 1
    assert np.abs(np.asarray(layer9[0]) - ref).max() > 0.1


def test_vit_out_channels_count_the_layers_it_reaches():
    """JAX's default indices on 12 layers reach one (9), so one width."""
    mod = VisionTransformer(**dict(SEGMENTER_VIT,
                                   out_indices=(9, 14, 19, 23)))
    assert mod.out_channels == [16]
    with torch.no_grad():
        assert len(mod(torch.zeros(1, 3, 64, 64))) == 1
