"""The stock zoo's configs with a neck against the JAX package, on the
CPU: the semantic FPN-R50 (``configs/sem_fpn/fpn_r50_512x512_160k_
ade20k.py``), FastFCN-R50 JPU-PSP (``configs/fastfcn/fastfcn_r50-d32_
jpu_psp_512x512_80k_ade20k.py``) and UPerNet ViT-B/16-MLN
(``configs/vit/upernet_vit-b16_mln_512x512_160k_ade20k.py``), their
pretrained paths removed.

Each at tiny widths (ResNet stem and base 8, the neck and heads 8 or 16
wide; the ViT 16 wide, 4 layers of 2 heads on 64² images with a 16-pixel
patch) and 3 classes: every flax leaf through the bridge, eval logits,
the loss dict with ``aux.*``, three steps from JAX's state (Adam for the
two ResNet models, the ViT config's own AdamW and ``paramwise_cfg`` for
the ViT, one compiled JAX step a config; the ResNet models' steps on 128²
images, where their stride-32 BNs see 32 values a channel), the ViT config's
``(lr_mult, decay_mult)`` leaf by leaf; the segmentor's graph (backbone →
neck → every head; ``extract_feat`` is the neck's output); and each
config at full width through ``init_segmentor`` with JAX's parameter
count. JAX variables are drawn with numpy (``tests/fixtures/
torch_port.py``) and carried by ``jax_to_torch_state`` with
``strict=True``.

Tolerances, f32, as ``tests/test_torch_swin_upernet.py`` and
``tests/test_torch_aux_heads.py`` hold the stock zoo: logits at rtol 1e-4
/ atol 1e-5, losses at rtol 1e-5, the steps as
``tests/fixtures/torch_monolithic.py`` holds them (the ResNet-50 models'
moves on 99 % of the strong coordinates, their ``acc_seg`` within 3
pixels: JAX's f32 gradient of the ResNet-50 BN bottlenecks is itself
some percent off float64).
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
from stc_unet_tpu_torch.apis import init_segmentor
from stc_unet_tpu_torch.core.optimizers.builder import _param_groups
from stc_unet_tpu_torch.models.necks import FPN, JPU, MultiLevelNeck
from stc_unet_tpu_torch.utils import Config
from stc_unet_tpu_torch.utils.jax_convert import port_key
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 64
CONFIGS = {'fpn': chip_smoke.ZOO_FPN, 'fastfcn': chip_smoke.ZOO_FASTFCN,
           'vit': chip_smoke.ZOO_VIT}
RESNET = dict(stem_channels=8, base_channels=8)
VIT = dict(img_size=SIZE, embed_dims=16, num_layers=4, num_heads=2,
           out_indices=(0, 1, 2, 3))


def tiny(config_cls, name, dropout=0.1):
    """``name``'s stock config at tiny widths, 3 classes, its
    pretrained path removed."""
    m = config_cls.fromfile(osp.join(REPO, CONFIGS[name])).to_dict()['model']
    m['pretrained'] = None
    heads = dict(num_classes=3, dropout_ratio=dropout)
    if name == 'fpn':
        m['backbone'].update(RESNET)
        m['neck'].update(in_channels=[32, 64, 128, 256], out_channels=8)
        m['decode_head'].update(in_channels=[8] * 4, channels=8, **heads)
    elif name == 'fastfcn':
        m['backbone'].update(RESNET)
        m['neck'].update(in_channels=(64, 128, 256), mid_channels=8)
        m['decode_head'].update(in_channels=32, channels=8, **heads)
        m['auxiliary_head'].update(in_channels=128, channels=8, **heads)
    else:
        m['backbone'].update(VIT)
        m['neck'].update(in_channels=[16] * 4, out_channels=16)
        m['decode_head'].update(in_channels=[16] * 4, channels=8, **heads)
        m['auxiliary_head'].update(in_channels=16, channels=8, **heads)
    return m


@pytest.fixture(scope='module', params=list(CONFIGS))
def pair(request):
    return (request.param,) + mono.build_pair(tiny(JConfig, request.param),
                                              SIZE)


def test_every_flax_leaf_round_trips_through_the_bridge(pair):
    """Each flax leaf lands on its own port key (plus a
    ``num_batches_tracked`` a BN), the key sets and parameter counts are
    equal, and the inverse layout of each port tensor is the flax leaf,
    bit for bit."""
    name, jm, tm = pair
    assert mono.check_leaves_and_count(jm, tm) > 0
    mono.check_round_trip(jm.variables, tm)
    keys = set(tm.state_dict())
    want = {
        'fpn': {'neck.lateral_convs.3.conv.weight',
                'neck.fpn_convs.0.conv.bias',
                'decode_head.scale_heads.3.4.conv.weight',
                'decode_head.scale_heads.0.0.bn.running_mean'},
        'fastfcn': {'neck.conv_layers.2.0.conv.weight',
                    'neck.dilation_layers.3.0.depthwise_conv.conv.weight',
                    'neck.dilation_layers.0.0.pointwise_conv.bn.bias',
                    'decode_head.psp_modules.3.1.conv.weight',
                    'auxiliary_head.convs.0.conv.weight'},
        'vit': {'backbone.patch_embed.projection.weight',
                'backbone.cls_token', 'backbone.pos_embed',
                'backbone.layers.3.attn.attn.in_proj_weight',
                'backbone.layers.0.attn.attn.out_proj.bias',
                'backbone.layers.1.ln2.weight',
                'backbone.layers.2.ffn.layers.0.0.weight',
                'neck.lateral_convs.3.conv.weight', 'neck.convs.0.conv.bias',
                'decode_head.fpn_bottleneck.conv.weight',
                'auxiliary_head.conv_seg.weight'},
    }[name]
    assert want <= keys


def test_logits_and_losses_match_jax(pair):
    """Eval logits; the loss dict in eval mode (running BN stats), the
    auxiliary head's at 0.4."""
    name, jm, tm = pair
    mono.check_logits(jm, tm, SIZE)
    img, gt = mono.train_batch(SIZE)
    ref, _ = jm.compute_losses(jm.variables, img, gt, jax.random.PRNGKey(0),
                               train=False)
    with torch.no_grad():
        losses = tm.compute_losses(img, gt)
    want = ['decode.acc_seg', 'decode.loss_ce']
    if name != 'fpn':
        want = ['aux.acc_seg', 'aux.loss_ce'] + want
    assert sorted(losses) == sorted(ref) == want
    for k, v in ref.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)


def test_every_head_reads_the_necks_outputs(pair):
    """Backbone → neck → every head, in inference, ``extract_feat`` and
    the losses: the decode and auxiliary heads get the neck's levels (the
    MultiLevelNeck's level 3 is half the ViT's map, the JPU's last its
    fused map), and ``extract_feat`` returns them."""
    name, _, tm = pair
    seen = {}

    def record(key):
        def hook(module, args):
            seen[key] = [tuple(t.shape) for t in args[0]]
        return hook

    hooks = [tm.decode_head.register_forward_pre_hook(record('decode')),
             tm.neck.register_forward_hook(
                 lambda m, a, out: seen.__setitem__(
                     'neck', [tuple(t.shape) for t in out]))]
    if tm.auxiliary_head is not None:
        hooks.append(tm.auxiliary_head.register_forward_pre_hook(
            record('aux')))
    img, gt = mono.train_batch(SIZE, n=1)
    with torch.no_grad():
        tm.compute_losses(img, gt)
    for h in hooks:
        h.remove()
    assert seen['decode'] == seen['neck']
    if name != 'fpn':
        assert seen['aux'] == seen['neck']
    feats = tm.extract_feat(img)
    assert [tuple(f.permute(0, 3, 1, 2).shape) for f in feats] == \
        seen['neck']
    backbone = [tuple(f.shape) for f in tm.backbone(
        torch.from_numpy(img).permute(0, 3, 1, 2))]
    if name == 'vit':
        assert seen['neck'][3][2] * 2 == backbone[3][2] == 4
    if name == 'fastfcn':
        assert seen['neck'][2] == (1, 32, 8, 8) and backbone[2][1] == 256


def test_train_steps_match_jax(pair):
    """Three steps, each from JAX's state: Adam for the ResNet models, the
    ViT config's AdamW (its betas, weight decay 0.01 and ``paramwise_cfg``;
    lr 1e-3 under the fixture's poly schedule) for the ViT, against
    optax's; the ResNet models on 128² images. The total loss is the sum
    of the heads'."""
    name, jm, _ = pair
    cfg = tiny(Config, name, dropout=0.0)
    kw = {}
    if name == 'vit':
        kw['optimizer'] = dict(_vit_optimizer(), lr=mono.ADAM_LR)
        img, gt = mono.train_batch(SIZE)
    else:
        # 128²: at 64² the stride-32 maps are 2x2, each train-mode BN there
        # takes its moments over 8 values a channel, and JAX's f32 forward
        # is itself 3.7e-5 off a float64 port run in the FPN's first loss
        # (the port's f32 4e-7) and 1e-3 in a FastFCN running mean; at
        # 128², 7e-7 and in the band (the variables do not depend on the
        # input size)
        img, gt = mono.train_batch(2 * SIZE)
    run = mono.jax_train_run(cfg, jm.variables, img, gt, **kw)
    heads = [k for k in run[0][0] if k.endswith('loss_ce')]
    assert all(abs(lv['loss'] - sum(lv[k] for k in heads)) < 1e-5
               for lv in run[0])
    if name != 'vit':
        kw.update(min_agree=0.99, acc_pixels=3)
    mono.check_train_steps(cfg, img, gt, run, **kw)


def _vit_optimizer():
    opt = dict(Config.fromfile(osp.join(REPO, chip_smoke.ZOO_VIT)).optimizer)
    opt.pop('_delete_', None)
    return opt


def test_vit_paramwise_mults_match_jax():
    """The (lr_mult, decay_mult) of every parameter under the ViT config's
    ``custom_keys`` ('pos_embed', 'cls_token', 'norm' without decay) leaf
    by leaf through the bridge: the JAX package matches its flax paths,
    where the LayerNorms are ``norm1``, ``norm2`` and ``norm1_final``, so
    the port's ``ln1``/``ln2`` take no decay either (mmseg's fork would
    decay them)."""
    m = tiny(JConfig, 'vit')
    m['backbone']['final_norm'] = True
    jm, tm = mono.build_pair(m, SIZE)
    paramwise = _vit_optimizer()['paramwise_cfg']
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
    for key in ('backbone.pos_embed', 'backbone.cls_token',
                'backbone.layers.0.ln1.weight', 'backbone.layers.3.ln2.bias',
                'backbone.ln1.weight'):
        assert port[key] == (1.0, 0.0), key
    for key in ('backbone.layers.0.attn.attn.in_proj_weight',
                'neck.convs.0.conv.weight',
                'decode_head.bottleneck.bn.weight'):
        assert port[key] == (1.0, 1.0), key


def test_segmentor_checks_the_necks_widths():
    """The neck sizes its convs from the backbone's widths, which must be
    the config's ``in_channels``."""
    m = tiny(Config, 'fpn')
    m['neck']['in_channels'] = [256, 512, 1024, 2048]
    with pytest.raises(AssertionError, match="backbone's widths"):
        init_segmentor(Config(dict(model=m)), device='cpu')


@pytest.mark.parametrize('name', list(CONFIGS))
def test_stock_config_builds_at_full_width(name):
    """``init_segmentor`` on the CPU (``chip_smoke.zoo_cfg``: pretrained
    weights stripped): the published widths, 150 classes, JAX's parameter
    count."""
    cfg = chip_smoke.zoo_cfg(Config, CONFIGS[name])
    tm = init_segmentor(cfg, device='cpu')
    assert tm.out_channels == 150
    if name == 'fpn':
        assert isinstance(tm.neck, FPN) and tm.auxiliary_head is None
        assert tm.neck.out_channels == [256] * 4
        assert tm.decode_head.scale_heads[3][4].conv.in_channels == 128
    elif name == 'fastfcn':
        assert isinstance(tm.neck, JPU)
        assert tm.neck.out_channels == [512, 1024, 2048]
        assert tm.decode_head.bottleneck.conv.in_channels == 2048 + 4 * 512
        assert tm.auxiliary_head.convs[0].conv.in_channels == 1024
    else:
        assert isinstance(tm.neck, MultiLevelNeck)
        assert len(tm.backbone.layers) == 12
        assert tm.backbone.pos_embed.shape == (1, 32 * 32 + 1, 768)
        assert tm.backbone.out_indices == (2, 5, 8, 11)
        assert tm.neck.scales == (4, 2, 1, 0.5)
        assert tm.decode_head.fpn_bottleneck.conv.in_channels == 4 * 512
    jm = jax_build(chip_smoke.zoo_cfg(JConfig, CONFIGS[name]).model)
    shapes = jax.eval_shape(lambda k: jm.net.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False,
        method=EncoderDecoderNet.forward_heads), jax.random.PRNGKey(0))
    count = sum(int(np.prod(v.shape)) for _, v in
                mono.leaves(dict(shapes['params'])))
    assert count == sum(p.numel() for p in tm.parameters())
    assert count == {'fpn': 28514806, 'fastfcn': 68811916,
                     'vit': 144173612}[name]
