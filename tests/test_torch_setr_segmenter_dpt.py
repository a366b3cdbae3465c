"""The stock zoo's configs of the ViT's heads against the JAX package, on
the CPU: SETR-PUP (``configs/setr/setr_pup_512x512_160k_b16_ade20k.py``),
SETR-MLA (``setr_mla_512x512_160k_b8_ade20k.py``), SETR-naive
(``setr_naive_512x512_160k_b16_ade20k.py``), Segmenter ViT-B
(``configs/segmenter/segmenter_vit-b_mask_8x1_512x512_160k_ade20k.py``)
and DPT ViT-B (``configs/dpt/dpt_vit-b16_512x512_160k_ade20k.py``), their
pretrained paths removed.

Each at tiny widths (the ViT 16 wide, 4 layers of 2 heads on 64² images
with a 16-pixel patch; the heads 4 to 16 wide) and 3 classes: every flax
leaf through the bridge, eval logits, the loss dict with the auxiliary
heads' ``aux_{i}.*``, three steps from JAX's state with each config's
own optimizer and ``paramwise_cfg`` (SETR's SGD with the heads at 10x the
lr, the Segmenter's SGD, DPT's AdamW; one compiled JAX step a config),
the ``(lr_mult, decay_mult)`` of every leaf; the SETR ViT's bilinear
position grid on an input that is not its ``img_size``; SETR-naive's
slide logits on an image wider than its crop; and each config at full
width with JAX's parameter count, built on the ``meta`` device (ViT-L's
weights are not allocated). The Segmenter's ViT takes mmseg's default
``out_indices`` (-1) in the port and JAX's explicit ``(3,)``: JAX's own
default would read layer 9. JAX variables are drawn with numpy
(``tests/fixtures/torch_port.py``) and carried by ``jax_to_torch_state``
with ``strict=True``.

Tolerances, f32, as ``tests/test_torch_vit_fpn_zoo.py`` holds the stock
zoo: logits at rtol 1e-4 / atol 1e-5 (the slide logits too), losses at
rtol 1e-5, the steps as ``tests/fixtures/torch_monolithic.py`` holds them
(SETR-MLA's ``acc_seg`` within two pixels: a tie flips one,
``test_train_steps_match_jax``). The Segmenter's masks are held at the
same 1e-4 / 1e-5.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stc_unet_tpu.core.optimizers.builder import _paramwise_masks
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.core.optimizers.builder import _param_groups
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import (
    DPTHead, FCNHead, SegmenterMaskTransformerHead, SETRMLAHead, SETRUPHead)
from stc_unet_tpu_torch.models.necks import MLANeck
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from stc_unet_tpu_torch.utils.jax_convert import port_key
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 64
SETR_NAIVE = 'configs/setr/setr_naive_512x512_160k_b16_ade20k.py'
CONFIGS = {'setr_pup': chip_smoke.ZOO_SETR_PUP,
           'setr_mla': chip_smoke.ZOO_SETR_MLA, 'setr_naive': SETR_NAIVE,
           'segmenter': chip_smoke.ZOO_SEGMENTER, 'dpt': chip_smoke.ZOO_DPT}
VIT = dict(img_size=SIZE, embed_dims=16, num_layers=4, num_heads=2)


def tiny(config_cls, name, dropout=0.1, img_size=SIZE):
    """``name``'s stock config at tiny widths, 3 classes, its pretrained
    paths removed; for the JAX package (``config_cls`` its ``Config``) the
    Segmenter's ViT at ``out_indices=(3,)``, its last layer."""
    cfg = config_cls.fromfile(osp.join(REPO, CONFIGS[name]))
    m = cfg.to_dict()['model']
    m['pretrained'] = None
    m['backbone'].update(VIT, img_size=img_size, init_cfg=None)
    heads = dict(num_classes=3, dropout_ratio=dropout)
    aux = m.get('auxiliary_head') or []
    if name.startswith('setr'):
        m['backbone']['out_indices'] = (0, 1, 2, 3)
    if name in ('setr_pup', 'setr_naive'):
        m['decode_head'].update(in_channels=16, channels=8, **heads)
        for a in aux:
            a.update(in_channels=16, channels=8, **heads)
    elif name == 'setr_mla':
        m['neck'].update(in_channels=[16] * 4, out_channels=8)
        m['decode_head'].update(in_channels=(8,) * 4, channels=16,
                                mla_channels=4, **heads)
        for a in aux:
            a.update(in_channels=8, channels=8, **heads)
    elif name == 'segmenter':
        if config_cls is JConfig:
            m['backbone']['out_indices'] = (3,)
        m['decode_head'].update(in_channels=16, channels=16, embed_dims=16,
                                num_heads=2, **heads)
    else:
        m['backbone']['out_indices'] = (0, 1, 2, 3)
        m['decode_head'].update(in_channels=(16,) * 4, channels=8,
                                embed_dims=16,
                                post_process_channels=[2, 4, 4, 8], **heads)
    if name == 'setr_naive':
        m['test_cfg'] = dict(mode='slide', crop_size=(SIZE, SIZE),
                             stride=(43, 43))
    return m


def optimizer(name):
    """The config's own optimizer (its schedule file's, merged), at the
    fixture's lr."""
    opt = dict(Config.fromfile(osp.join(REPO, CONFIGS[name])).optimizer)
    opt.pop('_delete_', None)
    return dict(opt, lr=mono.ADAM_LR)


def build_pair(name, dropout=0.1, img_size=SIZE):
    """(JAX segmentor with numpy-drawn variables, the port's model with
    them, loaded strictly)."""
    jm = jax_build(tiny(JConfig, name, dropout, img_size))
    jm.variables = random_variables(
        jm.net, jnp.zeros((1, SIZE, SIZE, 3)), seed=0, train=False,
        method=EncoderDecoderNet.forward_heads)
    tm = build_segmentor(tiny(Config, name, dropout, img_size))
    tm.load_state_dict(jax_to_torch_state(jm.variables, tm), strict=True)
    return jm, tm.to(memory_format=torch.channels_last)


@pytest.fixture(scope='module', params=list(CONFIGS))
def pair(request):
    return (request.param,) + build_pair(request.param)


def test_every_flax_leaf_round_trips_through_the_bridge(pair):
    """Each flax leaf lands on its own port key (plus a
    ``num_batches_tracked`` a BN), the key sets and parameter counts are
    equal, and the inverse layout of each port tensor is the flax leaf,
    bit for bit (DPT's bare transposed-conv kernels flipped)."""
    name, jm, tm = pair
    assert mono.check_leaves_and_count(jm, tm) > 0
    mono.check_round_trip(jm.variables, tm)
    keys = set(tm.state_dict())
    want = {
        'setr_pup': {'decode_head.norm.weight',
                     'decode_head.up_convs.3.0.conv.weight',
                     'decode_head.up_convs.0.0.bn.running_mean',
                     'auxiliary_head.2.up_convs.1.0.conv.weight',
                     'backbone.layers.3.attn.attn.in_proj_weight'},
        'setr_mla': {'neck.norm.3.weight', 'neck.mla.channel_proj.0.conv'
                     '.weight', 'decode_head.up_convs.3.1.conv.weight',
                     'decode_head.up_convs.0.0.bn.weight',
                     'auxiliary_head.3.conv_seg.weight'},
        'setr_naive': {'decode_head.up_convs.0.0.conv.weight',
                       'auxiliary_head.0.up_convs.1.0.bn.bias'},
        'segmenter': {'backbone.ln1.weight', 'decode_head.cls_emb',
                      'decode_head.dec_proj.weight',
                      'decode_head.layers.1.attn.attn.in_proj_bias',
                      'decode_head.layers.0.ffn.layers.1.weight',
                      'decode_head.mask_norm.weight',
                      'decode_head.classes_proj.weight'},
        'dpt': {'decode_head.reassemble_blocks.readout_projects.3.0.weight',
                'decode_head.reassemble_blocks.projects.0.conv.weight',
                'decode_head.reassemble_blocks.resize_layers.1.weight',
                'decode_head.reassemble_blocks.resize_layers.3.weight',
                'decode_head.fusion_blocks.2.res_conv_unit1.conv2.bn.bias',
                'decode_head.project.conv.weight'},
    }[name]
    assert want <= keys


def test_logits_and_losses_match_jax(pair):
    """Eval logits; the loss dict in eval mode (running BN stats), each
    auxiliary head's at 0.4."""
    name, jm, tm = pair
    mono.check_logits(jm, tm, SIZE)
    img, gt = mono.train_batch(SIZE)
    ref, _ = jm.compute_losses(jm.variables, img, gt, jax.random.PRNGKey(0),
                               train=False)
    with torch.no_grad():
        losses = tm.compute_losses(img, gt)
    n_aux = {'setr_pup': 3, 'setr_mla': 4, 'setr_naive': 3}.get(name, 0)
    want = sorted(['decode.acc_seg', 'decode.loss_ce'] + [
        f'aux_{i}.{k}' for i in range(n_aux) for k in ('acc_seg',
                                                        'loss_ce')])
    assert sorted(losses) == sorted(ref) == want
    for k, v in ref.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)


def test_train_steps_match_jax(pair):
    """Three steps, each from JAX's state, with the config's own optimizer
    and ``paramwise_cfg`` (lr 1e-3 under the fixture's poly schedule)
    against optax's. The total loss is the sum of the heads'."""
    name, jm, _ = pair
    opt = optimizer(name)
    img, gt = mono.train_batch(SIZE)
    run = mono.jax_train_run(tiny(JConfig, name, dropout=0.0), jm.variables,
                             img, gt, optimizer=opt)
    heads = [k for k in run[0][0] if k.endswith('loss_ce')]
    assert all(abs(lv['loss'] - sum(lv[k] for k in heads)) < 1e-5
               for lv in run[0])
    # SETR-MLA's auxiliary FCNHeads classify the 4x4 neck maps as they
    # are: each 64² label map reads 16 logits a class, spread bilinearly,
    # and in its second step a pixel of ``aux_2`` sits on a tie of 1.1e-6
    # between two classes, which f32 rounding decides either way: one
    # pixel, whose share in the f32 percentages comes out a hair over the
    # fixture's ``pixel``, so the bound is two
    kw = dict(acc_pixels=2) if name == 'setr_mla' else {}
    mono.check_train_steps(tiny(Config, name, dropout=0.0), img, gt, run,
                           optimizer=opt, **kw)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_paramwise_mults_match_jax(name):
    """The (lr_mult, decay_mult) of every parameter under the config's
    ``paramwise_cfg`` leaf by leaf through the bridge (SETR: every head,
    the auxiliary SETRUPHeads and FCNHeads too, at 10x the lr; DPT:
    'pos_embed', 'cls_token' and 'norm' without decay). The Segmenter has
    none; its head is also held under DPT's keys: the ViT layers of its
    head match 'norm' by their JAX names, its ``cls_emb`` matches none."""
    jm, tm = build_pair(name)
    paramwise = optimizer(name).get('paramwise_cfg') or {}
    if name == 'segmenter':
        paramwise = optimizer('dpt')['paramwise_cfg']
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
    want = {
        'setr_pup': {'decode_head.norm.weight': (10.0, 1.0),
                     'auxiliary_head.1.up_convs.0.0.conv.weight':
                     (10.0, 1.0), 'backbone.pos_embed': (1.0, 1.0)},
        'setr_mla': {'auxiliary_head.0.conv_seg.weight': (10.0, 1.0),
                     'decode_head.up_convs.2.1.bn.weight': (10.0, 1.0),
                     'neck.norm.0.weight': (1.0, 1.0)},
        'setr_naive': {'decode_head.conv_seg.bias': (10.0, 1.0),
                       'backbone.layers.0.ln1.weight': (1.0, 1.0)},
        'segmenter': {'decode_head.layers.0.ln1.weight': (1.0, 0.0),
                      'decode_head.decoder_norm.bias': (1.0, 0.0),
                      'decode_head.mask_norm.weight': (1.0, 0.0),
                      'decode_head.cls_emb': (1.0, 1.0),
                      'backbone.cls_token': (1.0, 0.0),
                      'backbone.ln1.weight': (1.0, 0.0)},
        'dpt': {'backbone.pos_embed': (1.0, 0.0),
                'backbone.layers.2.ln2.bias': (1.0, 0.0),
                'decode_head.reassemble_blocks.readout_projects.0.0.weight':
                (1.0, 1.0), 'decode_head.project.bn.weight': (1.0, 1.0)},
    }[name]
    for key, mults in want.items():
        assert port[key] == mults, key


def test_setr_position_grid_is_resized_bilinearly():
    """SETR's ViT (``interpolate_mode='bilinear'``) at ``img_size`` 48 on
    64² images: its 3x3 position grid resized bilinearly to the 4x4
    tokens, the logits held to JAX's."""
    jm, tm = build_pair('setr_pup', img_size=48)
    assert tm.backbone.interpolate_mode == 'bilinear'
    assert tm.backbone.pos_embed.shape == (1, 10, 16)
    mono.check_logits(jm, tm, SIZE)


def test_setr_naive_slide_logits_match_jax():
    """SETR-naive's slide inference (its ``test_cfg`` cut to a 64 crop,
    stride 43) on 64x112 images: three overlapping tiles, 150 classes at
    the stock width cut to 3, against JAX's slide inference."""
    jm, tm = build_pair('setr_naive')
    offsets, crop = tm._slide_offsets(SIZE, 112)
    assert offsets == jm._slide_offsets(SIZE, 112)[0] == (
        (0, 0), (0, 43), (0, 48)) and crop == (SIZE, SIZE)
    img = np.random.RandomState(7).rand(2, SIZE, 112, 3).astype(np.float32)
    ref = np.asarray(jm.slide_inference(img, None, False))
    out = tm.slide_inference(img, None, False)
    assert out.shape == (2, SIZE, 112, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name', list(CONFIGS))
def test_stock_config_builds_at_full_width(name):
    """The published widths, 150 classes (``chip_smoke.zoo_cfg``:
    pretrained weights stripped), built on the ``meta`` device, with
    JAX's parameter count."""
    cfg = chip_smoke.zoo_cfg(Config, CONFIGS[name])
    with torch.device('meta'):
        tm = build_segmentor(cfg.model)
    assert tm.num_classes == 150
    head = tm.decode_head
    if name.startswith('setr'):
        assert len(tm.backbone.layers) == 24
        assert tm.backbone.interpolate_mode == 'bilinear'
        assert tm.backbone.pos_embed.shape == (1, 32 * 32 + 1, 1024)
    else:
        assert len(tm.backbone.layers) == 12
    if name == 'setr_pup':
        assert isinstance(head, SETRUPHead) and len(head.up_convs) == 4
        assert head.up_convs[0][1].scale_factor == 2
        assert [len(a.up_convs) for a in tm.auxiliary_head] == [2, 2, 2]
        assert tm.auxiliary_head[0].up_convs[1][1].scale_factor == 4
    elif name == 'setr_naive':
        assert isinstance(head, SETRUPHead) and len(head.up_convs) == 1
        assert head.up_convs[0][0].conv.kernel_size == (1, 1)
    elif name == 'setr_mla':
        assert isinstance(tm.neck, MLANeck) and isinstance(head, SETRMLAHead)
        assert not tm.backbone.with_cls_token
        assert tm.backbone.out_indices == (5, 11, 17, 23)
        assert head.conv_seg.in_channels == 512
        assert all(isinstance(a, FCNHead) and len(a.convs) == 0
                   for a in tm.auxiliary_head)
    elif name == 'segmenter':
        assert isinstance(head, SegmenterMaskTransformerHead)
        assert tm.backbone.out_indices == (11,)
        assert hasattr(tm.backbone, 'ln1')
        assert head.cls_emb.shape == (1, 150, 768)
        assert len(head.layers) == 2 and tm.auxiliary_head is None
    else:
        assert isinstance(head, DPTHead) and tm.backbone.output_cls_token
        assert tm.backbone.side == 14 and tm.backbone.out_indices == (
            2, 5, 8, 11)
        assert len(head.reassemble_blocks.readout_projects) == 4
    jm = jax_build(chip_smoke.zoo_cfg(JConfig, CONFIGS[name]).model)
    shapes = jax.eval_shape(lambda k: jm.net.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False,
        method=EncoderDecoderNet.forward_heads), jax.random.PRNGKey(0))
    count = sum(int(np.prod(v.shape)) for _, v in
                mono.leaves(dict(shapes['params'])))
    assert count == sum(p.numel() for p in tm.parameters())
    assert count == {'setr_pup': 317291096, 'setr_mla': 309570286,
                     'setr_naive': 305558616, 'segmenter': 102497580,
                     'dpt': 109705046}[name]
