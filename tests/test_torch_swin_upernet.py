"""The Swin backbone, UPerHead and FCNHead, and the stock zoo's Swin-T
UPerNet (``configs/swin/upernet_swin_tiny_patch4_window7_512x512_160k_
ade20k_pretrain_224x224_1K.py``, its ``Pretrained`` init_cfg removed)
against the JAX package, on the CPU.

``SwinTransformerBlock(pad_to_window=True)`` at maps of 16x16, 9x13 and
5x6 (smaller than the window, which must not shrink); a tiny
``SwinTransformer`` (embed 8, depths (2, 2), heads (1, 2), window 7) at
64², 60x44 (odd stage maps: the merge pads) and 62x45 (the patch embed
pads); the heads at small shapes, in eval and in training with their BN
stats; the config cut to that backbone (UPerHead over its two levels,
the auxiliary FCNHead on the second, 8 channels, 3 classes) on 64²
images: logits, the loss dict with ``aux.*``, three Adam steps, and one
AdamW step under the config's ``paramwise_cfg``. JAX variables are drawn
with numpy (``tests/fixtures/torch_port.py``) and carried by
``jax_to_torch_state`` with ``strict=True``.

Tolerances, f32: a block at rtol 1e-5 / atol 1e-6; the backbone's
features and the heads at rtol 1e-5 / atol 1e-5 (BN in training also its
running stats); the segmentor's logits at rtol 1e-4 / atol 1e-5 and its
losses at rtol 1e-5; the steps as ``tests/fixtures/torch_monolithic.py``
holds them (each from JAX's state; every dropout and drop-path rate 0).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.core.optimizers.builder import _paramwise_masks
from stc_unet_tpu.models import build_head as jax_head
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.backbones.swin import \
    SwinTransformer as JaxSwinTransformer
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu.models.utils import swin_core as jsc
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.apis import init_segmentor
from stc_unet_tpu_torch.core.optimizers.builder import _param_groups
from stc_unet_tpu_torch.models import build_head, build_segmentor
from stc_unet_tpu_torch.models.backbones.swin import (PatchMerging,
                                                      SwinTransformer)
from stc_unet_tpu_torch.models.utils import swin_core as tsc
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from stc_unet_tpu_torch.utils.jax_convert import merge_order, merged, port_key
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401
from tests.test_torch_psp_aspp import (apply_jax, check_stats, load, nchw,
                                       nhwc, rand)

SWIN = osp.join(REPO, 'configs', 'swin', 'upernet_swin_tiny_patch4_window7_'
                '512x512_160k_ade20k_pretrain_224x224_1K.py')
SIZE = 64
TINY = dict(embed_dims=8, depths=(2, 2), num_heads=(1, 2), window_size=7,
            drop_path_rate=0.0, out_indices=(0, 1))


def tiny(config_cls, dropout=0.1):
    """The config at tiny widths, its Pretrained init_cfg removed."""
    cfg = config_cls.fromfile(SWIN)
    m = cfg.to_dict()['model']
    m['backbone'].pop('init_cfg')
    m['backbone'].update(TINY)
    m['decode_head'].update(in_channels=[8, 16], in_index=[0, 1],
                            channels=8, num_classes=3,
                            dropout_ratio=dropout)
    m['auxiliary_head'].update(in_channels=16, in_index=1, channels=8,
                               num_classes=3, dropout_ratio=dropout)
    return m


@pytest.fixture(scope='module')
def pair():
    return mono.build_pair(tiny(JConfig), SIZE)


# -- the padded block and the backbone ---------------------------------------

@pytest.mark.parametrize('shift', [0, 3])
@pytest.mark.parametrize('res', [(16, 16), (9, 13), (5, 6)])
def test_padded_swin_block_matches_jax(res, shift):
    """The window stays 7 at every map, the shift too; the norm1 output
    is padded to a window multiple and the mask made over the padded
    canvas."""
    x = np.random.RandomState(sum(res) + shift).randn(
        2, res[0] * res[1], 16).astype(np.float32)
    kw = dict(window_size=7, shift_size=shift, mlp_ratio=2.0,
              pad_to_window=True)
    jmod = jsc.SwinTransformerBlock(16, res, 2, **kw)
    v = random_variables(jmod, jnp.asarray(x), seed=1)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = tsc.SwinTransformerBlock(16, res, 2, **kw).eval()
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    assert (mod.window_size, mod.shift_size) == (7, shift)
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('hw', [(64, 64), (60, 44), (62, 45)])
def test_backbone_matches_jax(hw):
    """Features at strides 4 and 8: 16x16 and 8x8 tokens; 15x11 (stage 0
    odd: the merge pads to 16x12) and 6x8; 16x12 (62x45 padded to 64x48
    by the patch embed) and 8x6."""
    x = rand(2, *hw, 3, seed=hw[0])
    jmod = JaxSwinTransformer(**TINY)
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    ref = jax.jit(jmod.apply)(v, jnp.asarray(x))
    mod = SwinTransformer(**TINY).eval()
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    assert mod.out_channels == [8, 16]
    with torch.no_grad():
        outs = mod(nchw(x))
    assert len(outs) == len(ref) == 2
    for out, r in zip(outs, ref):
        assert nhwc(out).shape == r.shape
        np.testing.assert_allclose(nhwc(out), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('hw', [(4, 6), (5, 7)])
def test_patch_merging_is_the_unfold_order(hw):
    """The fork's merge: nn.Unfold's 2x2 blocks (channel-major), after an
    odd map is padded to even, then LN and the reduction."""
    torch.manual_seed(0)
    h, w = hw
    mod = PatchMerging(3, 6).eval()
    with torch.no_grad():
        mod.norm.weight.normal_()
        mod.norm.bias.normal_()
    x = torch.randn(2, h * w, 3)
    out, shape = mod(x, (h, w))
    img = torch.nn.functional.pad(x.reshape(2, h, w, 3).permute(0, 3, 1, 2),
                                  (0, w % 2, 0, h % 2))
    cols = torch.nn.Unfold(2, stride=2)(img).transpose(1, 2)
    with torch.no_grad():
        want = mod.reduction(mod.norm(cols))
    assert shape == ((h + 1) // 2, (w + 1) // 2)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_backbone_refusals_and_checks():
    for kw, err in ((dict(use_abs_pos_embed=True), 'use_abs_pos_embed'),
                    (dict(qk_scale=0.5), 'qk_scale'),
                    (dict(act_cfg=dict(type='ReLU')), 'GELU'),
                    (dict(frozen_stages=1), 'frozen_stages'),
                    (dict(pretrained='swin.pth'), 'pretrained'),
                    (dict(init_cfg=dict(type='Pretrained',
                                        checkpoint='swin.pth')),
                     'pretrained')):
        with pytest.raises(NotImplementedError, match=err):
            SwinTransformer(**TINY, **kw)
    with pytest.raises(AssertionError, match='non-overlapping'):
        SwinTransformer(**TINY, strides=(2, 2))
    with pytest.raises(AssertionError, match='tuple length'):
        SwinTransformer(**TINY, pretrain_img_size=(1, 2, 3))
    with pytest.raises(TypeError, match='pretrain_img_size'):
        SwinTransformer(**TINY, pretrain_img_size=2.0)
    with pytest.raises(TypeError, match='str path'):
        SwinTransformer(**TINY, pretrained=3)


def test_drop_path_rates_rise_over_all_blocks():
    m = SwinTransformer(depths=(2, 2, 6, 2), drop_path_rate=0.3,
                        embed_dims=8, num_heads=(1, 1, 1, 1))
    rates = [b.attn.drop.rate for s in m.stages for b in s.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 12))
    assert rates == [b.ffn.dropout_layer.rate for s in m.stages
                     for b in s.blocks]


# -- the heads --------------------------------------------------------------

HEADS = {
    'uper': (dict(type='UPerHead', in_channels=[4, 8, 16, 32], channels=8,
                  num_classes=3, norm_cfg=dict(type='BN'),
                  pool_scales=(1, 2, 3, 6)),
             [(2, 16, 16, 4), (2, 8, 8, 8), (2, 4, 4, 16), (2, 2, 2, 32)]),
    'fcn-aux': (dict(type='FCNHead', in_channels=16, channels=8, num_convs=1,
                     concat_input=False, num_classes=3, in_index=2,
                     norm_cfg=dict(type='BN')),
                [(2, 16, 16, 4), (2, 8, 8, 8), (2, 5, 7, 16)]),
    'fcn': (dict(type='FCNHead', in_channels=8, channels=4, num_classes=3,
                 in_index=-1, norm_cfg=dict(type='BN')), [(2, 8, 8, 8)]),
    'fcn-dilated': (dict(type='FCNHead', in_channels=8, channels=4,
                         num_classes=3, kernel_size=3, dilation=2,
                         norm_cfg=dict(type='BN'), in_index=0),
                    [(2, 9, 9, 8)]),
}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', list(HEADS))
def test_head_matches_jax(name, train):
    """Eval, and training without dropout (its running stats too); the
    UPerHead's 2x2 top level pools into overlapping 3 and 6 bins."""
    cfg, shapes = HEADS[name]
    cfg = dict(cfg, dropout_ratio=0.0)
    inputs = [rand(*s, seed=i) for i, s in enumerate(shapes)]
    ref, v, upd = apply_jax(jax_head(cfg), inputs, train=train)
    head = load(build_head(cfg), v).train(train)
    with torch.no_grad():
        out = head([nchw(x) for x in inputs])
    level = shapes[0] if name == 'uper' else \
        shapes[cfg['in_index'] if name != 'fcn' else -1]
    assert out.shape[1:] == (3,) + level[1:3]
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if train:
        check_stats(head, upd)


def test_head_keys_are_mmsegs():
    keys = set(build_head(HEADS['uper'][0]).state_dict())
    assert {'psp_modules.3.1.conv.weight', 'bottleneck.bn.running_mean',
            'lateral_convs.2.conv.weight', 'fpn_convs.0.bn.weight',
            'fpn_bottleneck.conv.weight', 'conv_seg.weight'} <= keys
    assert not any(k.startswith(('lateral_convs.3', 'fpn_convs.3'))
                   for k in keys)
    head = build_head(HEADS['uper'][0])
    assert head.fpn_bottleneck.conv.in_channels == 4 * 8
    keys = set(build_head(HEADS['fcn'][0]).state_dict())
    assert {'convs.0.conv.weight', 'convs.1.bn.running_var',
            'conv_cat.conv.weight', 'conv_seg.bias'} <= keys


# -- the config ---------------------------------------------------------------

def test_every_flax_leaf_round_trips_through_the_bridge(pair):
    """Each flax leaf lands on its own port key (plus a
    ``num_batches_tracked`` a BN and a ``relative_position_index`` a bias
    table), the key sets and parameter counts are equal, and the inverse
    layout of each port tensor is the flax leaf, bit for bit: a merge's
    4C axis permuted back from the fork's order."""
    jm, tm = pair
    assert mono.check_leaves_and_count(jm, tm) > 0
    sd, modules = tm.state_dict(), dict(tm.named_modules())
    permuted = 0
    for c in ('params', 'batch_stats'):
        for path, v in mono.leaves(jm.variables[c]):
            key, tag = port_key(path, c, modules)
            t = sd[key].numpy()
            if merged(key, modules):
                permuted += 1
                back = np.empty_like(t)
                back[..., merge_order(t.shape[-1])] = t
                t = back
            if tag == 'conv_w' or (tag == 'kernel' and t.ndim == 4):
                t = np.transpose(t, (2, 3, 1, 0))
            elif tag == 'linear_w' or tag == 'kernel':
                t = t.T
            np.testing.assert_array_equal(t, np.asarray(v), err_msg=key)
    assert permuted == 3          # one merge: its norm and reduction
    for k, index in sd.items():
        if k.endswith('relative_position_index'):
            np.testing.assert_array_equal(
                index.numpy(), tsc.relative_position_index((7, 7)))


def test_fork_keys_are_present(pair):
    keys = set(pair[1].state_dict())
    b = 'backbone.stages.0'
    assert {'backbone.patch_embed.projection.weight',
            'backbone.patch_embed.norm.bias',
            f'{b}.blocks.1.attn.w_msa.relative_position_bias_table',
            f'{b}.blocks.1.attn.w_msa.relative_position_index',
            f'{b}.blocks.0.attn.w_msa.qkv.weight',
            f'{b}.blocks.0.attn.w_msa.proj.bias',
            f'{b}.blocks.0.norm1.weight', f'{b}.blocks.0.norm2.bias',
            f'{b}.blocks.0.ffn.layers.0.0.weight',
            f'{b}.blocks.0.ffn.layers.1.bias',
            f'{b}.downsample.norm.weight', f'{b}.downsample.reduction.weight',
            'backbone.norm0.weight', 'backbone.norm1.bias',
            'decode_head.lateral_convs.0.conv.weight',
            'decode_head.fpn_bottleneck.bn.running_mean',
            'auxiliary_head.convs.0.conv.weight',
            'auxiliary_head.conv_seg.weight'} <= keys
    assert not any(k.startswith('auxiliary_head.0') or 'attn_mask' in k
                   for k in keys)


def test_logits_and_losses_match_jax(pair):
    """Eval logits; the loss dict of both heads in eval mode (the running
    BN stats: no batch moments), the auxiliary head's weighted 0.4."""
    jm, tm = pair
    mono.check_logits(jm, tm, SIZE)
    img, gt = mono.train_batch(SIZE)
    ref, _ = jm.compute_losses(jm.variables, img, gt, jax.random.PRNGKey(0),
                               train=False)
    with torch.no_grad():
        losses = tm.compute_losses(img, gt)
    assert sorted(losses) == sorted(ref) == [
        'aux.acc_seg', 'aux.loss_ce', 'decode.acc_seg', 'decode.loss_ce']
    for k, v in ref.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)


def test_auxiliary_head_runs_in_training_only(pair):
    _, tm = pair
    calls = []
    hook = tm.auxiliary_head.register_forward_hook(
        lambda *args: calls.append(1))
    tm.encode_decode(mono.image(1, 32))
    assert calls == []
    with torch.no_grad():
        tm.compute_losses(*mono.train_batch(32, n=1))
    hook.remove()
    assert calls == [1]


def test_train_steps_match_jax(pair):
    jm, _ = pair
    cfg = tiny(Config, dropout=0.0)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(cfg, img, gt,
                           mono.jax_train_run(cfg, jm.variables, img, gt))


def _config_optimizer():
    opt = dict(Config.fromfile(SWIN).optimizer)
    opt.pop('_delete_', None)
    return opt


def test_paramwise_mults_match_jax(pair):
    """The (lr_mult, decay_mult) of every parameter under the config's
    ``custom_keys`` (substring matches on the names: the fork's keys in
    the port, the flax paths in JAX) leaf by leaf through the bridge; the
    norms and bias tables take no decay, the rest the config's."""
    jm, tm = pair
    paramwise = _config_optimizer()['paramwise_cfg']
    lr_m, decay_m = _paramwise_masks(jm.variables['params'], paramwise, 0.01)
    names = {id(p): k for k, p in tm.named_parameters()}
    port = {names[id(p)]: (g['lr_mult'], g['decay_mult'])
            for g in _param_groups(tm, paramwise) for p in g['params']}
    modules = dict(tm.named_modules())
    jax_mults = {}
    for path, lm in mono.leaves(lr_m):
        key, _ = port_key(path, 'params', modules)
        dm = decay_m
        for p in path:
            dm = dm[p]
        jax_mults[key] = (float(lm), float(dm))
    assert jax_mults == port
    assert port['backbone.stages.0.blocks.0.attn.w_msa.'
                'relative_position_bias_table'] == (1.0, 0.0)
    assert port['backbone.norm0.weight'] == (1.0, 0.0)
    assert port['backbone.stages.0.blocks.0.ffn.layers.0.0.weight'] == \
        (1.0, 1.0)
    assert sum(dm == 0.0 for _, dm in port.values()) > 10


def test_adamw_step_with_paramwise_decay_matches_optax(pair):
    """One step of the config's AdamW (its betas, weight decay 0.01 and
    ``paramwise_cfg``; lr 1e-3 under the fixture's poly schedule) against
    optax's, as the Adam steps are held: a decay taken where JAX takes
    none moves a weight of 0.1 by 1e-6, the bound of the strong
    coordinates' first moves."""
    jm, _ = pair
    cfg = tiny(Config, dropout=0.0)
    opt = dict(_config_optimizer(), lr=mono.ADAM_LR)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt,
        mono.jax_train_run(cfg, jm.variables, img, gt, steps=1,
                           optimizer=opt), optimizer=opt)


def test_stock_config_builds_at_full_width():
    """``init_segmentor`` on the CPU: Swin-T (embed 96, depths 2-2-6-2,
    heads 3-6-12-24, window 7), a 512-channel UPerHead and the auxiliary
    FCNHead on stage 2, 150 classes; the JAX parameter count. The
    ``Pretrained`` init_cfg raises until it is removed."""
    with pytest.raises(NotImplementedError, match='pretrained'):
        build_segmentor(Config.fromfile(SWIN).model)
    cfg = Config.fromfile(SWIN)
    cfg.model.backbone.init_cfg = None
    tm = init_segmentor(cfg, device='cpu')
    assert tm.backbone.out_channels == [96, 192, 384, 768]
    assert tm.decode_head.fpn_bottleneck.conv.in_channels == 4 * 512
    assert tm.auxiliary_head.convs[0].conv.in_channels == 384
    assert tm.out_channels == tm.auxiliary_head.final_out_channels == 150
    jcfg = JConfig.fromfile(SWIN).to_dict()['model']
    jcfg['backbone'].pop('init_cfg')
    jm = jax_build(jcfg)
    shapes = jax.eval_shape(lambda k: jm.net.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False,
        method=EncoderDecoderNet.forward_heads), jax.random.PRNGKey(0))
    count = sum(int(np.prod(v.shape)) for _, v in
                mono.leaves(dict(shapes['params'])))
    assert count == sum(p.numel() for p in tm.parameters())
