"""Auxiliary heads in the port's ``EncoderDecoder`` and FCNHead, and the
stock PSPNet (``configs/_base_/models/pspnet_r50-d8.py``: ResNetV1c-50,
PSPHead and an auxiliary FCNHead on stage 2 weighted 0.4) against the
JAX package, on the CPU.

The stock PSPNet at tiny widths (``stem_channels``/``base_channels`` 8,
head and auxiliary ``channels`` 8, its 19 classes) on 64² images, its
segmentor-level ``pretrained`` removed: logits, the loss dict with
``aux.*``, three Adam steps; with two auxiliary heads, the ``aux_{i}``
losses. FCNHead at the shapes of
``tests/test_models/test_heads/test_classic_heads.py``, with its
assertions. JAX variables are drawn with numpy
(``tests/fixtures/torch_port.py``) and carried by ``jax_to_torch_state``
with ``strict=True``.

Tolerances, f32: heads at rtol 1e-5 / atol 1e-5; logits at rtol 1e-4 /
atol 1e-5; losses at rtol 1e-5; the steps as
``tests/test_torch_psp_aspp.py`` holds the ResNet-50 models' (moves on
99 % of the strong coordinates: JAX's f32 gradient of these BN
bottlenecks is itself some percent off float64).
"""
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from stc_unet_tpu.models import build_head as jax_head
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.models import build_head, build_segmentor
from stc_unet_tpu_torch.utils import Config
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO
from tests.fixtures.torch_threads import torch_threads  # noqa: F401
from tests.test_torch_psp_aspp import apply_jax, load, nchw, nhwc, rand

PSPNET = osp.join(REPO, 'configs', '_base_', 'models', 'pspnet_r50-d8.py')
SIZE = 64


def tiny(config_cls, dropout=0.1, aux=None, classes=19):
    """The stock PSPNet at tiny widths, its pretrained path removed;
    ``aux`` replaces the auxiliary head config."""
    m = config_cls.fromfile(PSPNET).to_dict()['model']
    m['pretrained'] = None
    m['backbone'].update(stem_channels=8, base_channels=8)
    m['decode_head'].update(in_channels=256, channels=8,
                            dropout_ratio=dropout, num_classes=classes)
    m['auxiliary_head'].update(in_channels=128, channels=8,
                               dropout_ratio=dropout, num_classes=classes)
    if aux is not None:
        m['auxiliary_head'] = aux(m['auxiliary_head'])
    return m


@pytest.fixture(scope='module')
def pair():
    return mono.build_pair(tiny(JConfig), SIZE)


def test_every_flax_leaf_lands_on_the_forks_keys(pair):
    jm, tm = pair
    assert mono.check_leaves_and_count(jm, tm) > 0
    keys = set(tm.state_dict())
    assert {'auxiliary_head.convs.0.conv.weight',
            'auxiliary_head.convs.0.bn.running_var',
            'auxiliary_head.conv_seg.weight',
            'decode_head.psp_modules.3.1.conv.weight',
            'backbone.stem.0.weight', 'backbone.layer3.0.conv2.weight'} \
        <= keys
    assert not hasattr(tm.auxiliary_head, 'conv_cat')


def test_logits_and_losses_match_jax(pair):
    """Eval logits (the auxiliary head never runs there); the loss dict in
    eval mode, ``aux.loss_ce`` at 0.4 of its cross entropy."""
    jm, tm = pair
    calls = []
    hook = tm.auxiliary_head.register_forward_hook(
        lambda *args: calls.append(1))
    mono.check_logits(jm, tm, SIZE)
    assert calls == []
    hook.remove()
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


def test_train_steps_match_jax():
    """Three Adam steps; the total loss is the sum of both heads'. With
    2 classes (the KiTS labels of the trained protocol,
    ``tools/parity_pspnet.py``): at 19 the seeded auxiliary head's top two
    classes run within 4e-4 of each other on its 8x8 map, while JAX's f32
    forward of the train-mode BN bottlenecks puts 1.4e-4 of noise on its
    logits (the port's forward from the same state), so its pixel
    accuracy after two steps moved by 4 %. At 2 classes that noise still
    flips one of the 7378 labelled pixels in the third step
    (``decode.acc_seg`` 51.2668
    against 51.2532): each ``acc_seg`` is held within 3 pixels, as
    ``chip_smoke.py``'s ``train_check`` holds it, the losses to rtol
    1e-5."""
    jm, _ = mono.build_pair(tiny(JConfig, classes=2), SIZE)
    cfg = tiny(Config, dropout=0.0, classes=2)
    img, gt = mono.train_batch(SIZE)
    run = mono.jax_train_run(cfg, jm.variables, img, gt)
    assert all(abs(lv['loss'] - lv['decode.loss_ce'] - lv['aux.loss_ce'])
               < 1e-6 for lv in run[0])
    mono.check_train_steps(cfg, img, gt, run, min_agree=0.99, acc_pixels=3)


def test_a_list_of_auxiliary_heads_matches_jax():
    """Two auxiliary heads (stages 2 and 1): an ``nn.ModuleList`` as in
    mmseg (``auxiliary_head.{i}``), losses ``aux_0.*`` and ``aux_1.*``."""
    def two(aux):
        return [aux, dict(aux, in_channels=64, in_index=1, num_convs=2,
                          concat_input=True)]

    jm, tm = mono.build_pair(tiny(JConfig, 0.0, two), SIZE)
    assert isinstance(tm.auxiliary_head, torch.nn.ModuleList)
    assert 'auxiliary_head.1.conv_cat.conv.weight' in tm.state_dict()
    img, gt = mono.train_batch(SIZE)
    ref, _ = jm.compute_losses(jm.variables, img, gt, jax.random.PRNGKey(0),
                               train=False)
    with torch.no_grad():
        losses = tm.compute_losses(img, gt)
    assert sorted(losses) == sorted(ref)
    assert {'aux_0.loss_ce', 'aux_1.acc_seg'} <= set(losses)
    for k, v in ref.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)


FCN = [
    (dict(type='FCNHead', in_channels=8, channels=4, num_classes=3,
          in_index=-1, norm_cfg=dict(type='BN')), 'convs,cat'),
    (dict(type='FCNHead', in_channels=8, channels=4, num_classes=3,
          num_convs=1, concat_input=False), 'conv'),
    (dict(type='FCNHead', in_channels=8, channels=8, num_classes=3,
          num_convs=0, norm_cfg=dict(type='BN')), 'none'),
]


@pytest.mark.parametrize('cfg,kind', FCN, ids=[k for _, k in FCN])
def test_fcn_head_matches_jax(cfg, kind):
    """Two convs and ``conv_cat``; one conv without a norm (its conv takes
    a bias); no conv, where ``concat_input`` takes no ``conv_cat`` (the
    classifier sees the input, as in JAX)."""
    x = rand(1, 8, 8, 8)
    ref, v, _ = apply_jax(jax_head(cfg), [x])
    head = load(build_head(cfg), v).eval()
    with torch.no_grad():
        out = head([nchw(x)])
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert len(head.convs) == {'convs,cat': 2, 'conv': 1, 'none': 0}[kind]
    assert hasattr(head, 'conv_cat') == (kind == 'convs,cat')
    if kind == 'conv':
        assert head.convs[0].conv.bias is not None


@pytest.mark.parametrize('kw,match', [
    (dict(num_convs=-1), 'invalid num_convs'),
    (dict(dilation=0), 'invalid num_convs'),
    (dict(dilation=1.5), 'invalid num_convs'),
    (dict(num_convs=0, channels=4), 'num_convs=0 requires'),
])
def test_fcn_head_checks_match_jax(kw, match):
    cfg = dict(dict(type='FCNHead', in_channels=8, channels=8,
                    num_classes=3), **kw)
    with pytest.raises(AssertionError, match=match):
        jax_head(cfg)
    with pytest.raises(AssertionError, match=match):
        build_head(cfg)


def test_necks_and_pretrained_weights_still_raise():
    """A neck builds on the backbone's widths (the necks are ported) and
    raises where its ``in_channels`` are not those widths; a pretrained
    path or a ``Pretrained`` init_cfg (the backbone's or the segmentor's)
    raises rather than train from random weights."""
    base = tiny(Config)
    with pytest.raises(AssertionError, match="backbone's widths"):
        build_segmentor(dict(base, neck=dict(type='FPN')))
    fpn = build_segmentor(dict(base, neck=dict(
        type='FPN', in_channels=[32, 64, 128, 256], out_channels=256)))
    assert fpn.neck.out_channels == [256] * 4
    pretrained = dict(type='Pretrained', checkpoint='r50.pth')
    for cfg in (dict(base, pretrained='open-mmlab://resnet50_v1c'),
                dict(base, backbone=dict(base['backbone'],
                                         pretrained='r50.pth')),
                dict(base, backbone=dict(base['backbone'],
                                         init_cfg=pretrained)),
                dict(base, init_cfg=pretrained)):
        with pytest.raises(NotImplementedError, match='pretrained'):
            build_segmentor(cfg)


def test_stock_config_builds_at_full_width():
    """``init_segmentor`` on the CPU strips the segmentor's
    ``pretrained`` as JAX's does; ResNetV1c-50 at output stride 8, the
    PSPHead over 2048 channels and the auxiliary FCNHead over layer 3's
    1024, 19 classes."""
    from stc_unet_tpu_torch.apis import init_segmentor
    tm = init_segmentor(Config.fromfile(PSPNET), device='cpu')
    assert tm.backbone.out_channels == [256, 512, 1024, 2048]
    assert tm.auxiliary_head.convs[0].conv.in_channels == 1024
    assert tm.decode_head.bottleneck.conv.in_channels == 2048 + 4 * 512
    assert tm.auxiliary_head.loss_decode['loss_weight'] == 0.4
    assert tm.out_channels == 19


def test_parity_pspnet_runs_end_to_end(tmp_path):
    """``python -m stc_unet_tpu_torch.tools.parity_pspnet`` on the CPU at
    a tiny size (32², 4 train and 2 test images, one epoch of 2 steps,
    full width): both CLIs run, the steps log the auxiliary head's
    losses, and the record carries the port's metrics beside the JAX
    package's."""
    from stc_unet_tpu_torch.tools import parity_pspnet
    record = parity_pspnet.main([
        '--device', 'cpu', '--size', '32', '--train-imgs', '4',
        '--test-imgs', '2', '--epochs', '1', '--batch', '2',
        '--work-dir', str(tmp_path), '--out', str(tmp_path / 'r.json')])
    assert record['steps'] == 2 and osp.isfile(record['checkpoint'])
    assert record['aux_losses'] == ['aux.acc_seg', 'aux.loss_ce']
    assert all(np.isfinite(v).all() for v in record['losses'].values())
    assert 0 <= record['port']['mDice'] <= 1
    assert record['jax']['mDice'] == 0.9798
    assert record['jax']['source'] == 'PARITY_PSPNET.json'
    assert osp.isfile(tmp_path / 'r.json')
