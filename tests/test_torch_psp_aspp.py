"""The mmcv-style bricks, the PSP, ASPP and separable-ASPP heads, and
PSPNet and DeepLabv3+ end to end (``my_config/PSPNet.py``,
``my_config/DeepLabv3+.py``) against the JAX package, on the CPU.

Bricks on small random inputs; the heads at the shapes of
``tests/test_models/test_heads/test_classic_heads.py``; the two configs
at tiny widths (``stem_channels``/``base_channels`` 8, head ``channels``
8, ``c1_channels`` 4) on 64² images, so the output-stride-8 features are
8x8 and the PPM's 3 and 6 bins overlap. JAX variables are drawn with
numpy (``tests/fixtures/torch_port.py``) and carried by
``jax_to_torch_state``.

Tolerances, f32: activations at rtol 1e-5 / atol 1e-6; norms, bricks,
pools and heads at rtol 1e-5 / atol 1e-5 (BN in training also its
running stats); a bf16 pool to one bf16 ulp (2^-8 of the value); the
segmentors' logits at rtol 1e-4 / atol 1e-5 and their three Adam steps as
``tests/fixtures/torch_monolithic.py`` holds them (each from JAX's state;
the heads' dropout off on both sides).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models import bricks as jb
from stc_unet_tpu.models import build_head as jax_head
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.models import bricks as tb
from stc_unet_tpu_torch.models import build_head
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from stc_unet_tpu_torch.utils.jax_convert import translate_path
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO, random_variables, write_split
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 64


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def apply_jax(module, *inputs, seed=1, train=False):
    """``module`` (flax) with numpy-drawn variables on NHWC ``inputs``:
    (output, variables, updated batch stats or None)."""
    v = random_variables(module, *jax.tree_util.tree_map(jnp.asarray,
                                                         inputs), seed=seed)
    if train:
        out, upd = jax.jit(lambda v_, *x_: module.apply(
            v_, *x_, train=True, mutable=['batch_stats']))(v, *inputs)
        return out, v, upd['batch_stats']
    return jax.jit(module.apply)(v, *inputs), v, None


def load(module, v):
    module.load_state_dict(jax_to_torch_state(v, module), strict=True)
    return module


def check_stats(module, upd):
    sd = module.state_dict()
    want = jax_to_torch_state({'batch_stats': jax.tree_util.tree_map(
        np.asarray, upd)}, module)
    assert want
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            assert int(sd[k]) == 1, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


# -- bricks ----------------------------------------------------------------

@pytest.mark.parametrize('act', [None, 'ReLU', 'ReLU6', 'SiLU', 'Swish',
                                 'Sigmoid', 'Tanh', 'GELU', 'HSwish',
                                 'HSigmoid', 'Identity', 'LeakyReLU'])
def test_activation_matches_jax(act):
    cfg = None if act is None else dict(type=act)
    if act == 'LeakyReLU':
        cfg['negative_slope'] = 0.2
    x = rand(3, 5, 4, 2) * 4
    ref = np.asarray(jb.build_activation_layer(cfg)(jnp.asarray(x)))
    out = tb.build_activation_layer(cfg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unknown_activations_raise_as_in_jax():
    for cfg in (dict(type='PReLU'), dict(type='Mish')):
        with pytest.raises(KeyError, match='Unsupported activation'):
            jb.build_activation_layer(cfg)
        with pytest.raises(KeyError, match='Unsupported activation'):
            tb.build_activation_layer(cfg)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('cfg,name', [
    (dict(type='BN', requires_grad=True), 'bn'),
    (dict(type='SyncBN', eps=1e-3, momentum=0.3), 'bn'),
    (dict(type='GN', num_groups=2), 'gn'),
    (dict(type='LN', eps=1e-6), 'ln'),
    (dict(type='IN'), 'in'),
])
def test_norm_layer_matches_jax(cfg, name, train):
    x = rand(3, 5, 4, 6) * 2 + 1
    factory, _ = jb.build_norm_layer(cfg)
    jmod = factory()
    is_bn = name == 'bn'
    ref, v, upd = apply_jax(jmod, x, train=train and is_bn) if is_bn else \
        apply_jax(jmod, x)
    got_name, mod = tb.build_norm_layer(cfg, 6)
    assert got_name == name
    load(mod, v).train(train)
    with torch.no_grad():
        out = mod(nchw(x))
    if train and is_bn:
        check_stats(mod, upd)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert tb.build_norm_layer(None, 6) == (None, None)


@pytest.mark.parametrize('kw', [
    dict(kernel_size=3, padding=1, norm_cfg=dict(type='BN'),
         act_cfg=dict(type='ReLU')),
    dict(kernel_size=3, padding=2, dilation=2, stride=2,
         norm_cfg=dict(type='BN'), act_cfg=dict(type='ReLU'), train=True),
    dict(kernel_size=1, act_cfg=dict(type='PReLU')),
    dict(kernel_size=3, padding=1, bias=True, norm_cfg=dict(type='GN',
                                                            num_groups=5),
         act_cfg=dict(type='LeakyReLU')),
    dict(kernel_size=3, padding=1, norm_cfg=dict(type='BN'),
         act_cfg=dict(type='ReLU'), order=('norm', 'conv', 'act')),
    dict(kernel_size=3, padding=1, norm_cfg=dict(type='BN'),
         act_cfg=dict(type='PReLU'), order=('act', 'conv', 'norm')),
])
def test_conv_module_matches_jax(kw):
    """mmcv's rules: a bias only without a norm (``'auto'``), the norm
    over the input's channels when it comes before the conv, any order."""
    kw = dict(kw)
    train = kw.pop('train', False)
    x = rand(2, 9, 7, 6, seed=2)
    ref, v, upd = apply_jax(jb.ConvModule(5, **kw), x, train=train)
    mod = load(tb.ConvModule(6, 5, **kw), v).train(train)
    assert (mod.conv.bias is not None) == (kw.get('bias', 'auto') is True or
                                          'norm_cfg' not in kw)
    with torch.no_grad():
        out = mod(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if train:
        check_stats(mod, upd)


@pytest.mark.parametrize('kw', [
    dict(norm_cfg=dict(type='BN'), act_cfg=dict(type='ReLU')),
    dict(norm_cfg=dict(type='BN'), act_cfg=dict(type='ReLU'),
         dw_act_cfg=None, pw_norm_cfg=None),
])
def test_depthwise_separable_conv_module_matches_jax(kw):
    x = rand(2, 8, 8, 6, seed=3)
    ref, v, _ = apply_jax(jb.DepthwiseSeparableConvModule(
        5, 3, padding=2, dilation=2, **kw), x)
    mod = load(tb.DepthwiseSeparableConvModule(6, 5, 3, padding=2,
                                               dilation=2, **kw), v).eval()
    assert mod.depthwise_conv.conv.groups == 6
    with torch.no_grad():
        out = mod(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('args', [(2, None, 0, True), (3, 2, 1, True),
                                  (3, 2, 1, False), (2, 1, 0, True)])
def test_avg_pool2d_matches_jax(args):
    x = rand(2, 9, 8, 3, seed=4)
    ref = jb.avg_pool2d(jnp.asarray(x), *args)
    out = tb.avg_pool2d(nchw(x), *args)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('hw,size', [((64, 64), 1), ((64, 64), 2),
                                     ((64, 64), 3), ((64, 64), 6),
                                     ((8, 8), 3), ((8, 8), 6),
                                     ((13, 7), (6, None)), ((9, 9), 9)])
def test_adaptive_avg_pool2d_matches_jax_bins(hw, size):
    """torch's bins, which the JAX function reproduces: bin i of n over s
    spans [floor(i·s/n), ceil((i+1)·s/n)), overlapping where n does not
    divide s (64 into 3: [0, 22), [21, 43), [42, 64)); f32 and bf16."""
    x = rand(2, *hw, 4, seed=5)
    ref = jb.adaptive_avg_pool2d(jnp.asarray(x), size)
    out = tb.adaptive_avg_pool2d(nchw(x), size)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    refb = jb.adaptive_avg_pool2d(jnp.asarray(x, jnp.bfloat16), size)
    outb = tb.adaptive_avg_pool2d(nchw(x).bfloat16(), size)
    assert outb.dtype == torch.bfloat16
    refb = np.asarray(refb.astype(jnp.float32))
    np.testing.assert_allclose(nhwc(outb.float()), refb, rtol=2 ** -8,
                               atol=0)
    if hw == (64, 64) and size == 3:
        edges = ((0, 22), (21, 43), (42, 64))
        want = np.stack([x[:, a:b, 0:22].mean((1, 2)) for a, b in edges], 1)
        np.testing.assert_allclose(nhwc(out)[:, :, 0], want, rtol=1e-5,
                                   atol=1e-6)


def test_adaptive_max_pool2d_matches_jax():
    x = rand(2, 5, 6, 3, seed=6)
    ref = jb.adaptive_max_pool2d(jnp.asarray(x), 1)
    out = tb.adaptive_max_pool2d(nchw(x), 1)
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))
    for size in (2, (1, 2)):
        with pytest.raises(NotImplementedError, match='1x1'):
            jb.adaptive_max_pool2d(jnp.asarray(x), size)
        with pytest.raises(NotImplementedError, match='1x1'):
            tb.adaptive_max_pool2d(nchw(x), size)


# -- heads -----------------------------------------------------------------

HEADS = {
    'psp': (dict(type='PSPHead', in_channels=16, channels=8, num_classes=2,
                 pool_scales=(1, 2, 3, 6), norm_cfg=dict(type='BN'),
                 in_index=0), [(2, 12, 12, 16)]),
    'aspp': (dict(type='ASPPHead', in_channels=16, channels=8,
                  num_classes=2, dilations=(1, 6, 12),
                  norm_cfg=dict(type='BN'), in_index=0), [(2, 16, 16, 16)]),
    'sep-aspp-c1': (dict(type='DepthwiseSeparableASPPHead', in_channels=32,
                         channels=8, num_classes=2, dilations=(1, 6),
                         c1_in_channels=8, c1_channels=4,
                         norm_cfg=dict(type='BN'), in_index=-1),
                    [(2, 16, 16, 8), (2, 4, 4, 32)]),
    'sep-aspp': (dict(type='DepthwiseSeparableASPPHead', in_channels=32,
                      channels=8, num_classes=2, dilations=(1, 2),
                      c1_in_channels=0, norm_cfg=dict(type='BN'),
                      in_index=-1), [(2, 16, 16, 8), (2, 4, 4, 32)]),
}


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('name', list(HEADS))
def test_head_matches_jax(name, train):
    """Eval, and training without dropout (its running stats too)."""
    cfg, shapes = HEADS[name]
    cfg = dict(cfg, dropout_ratio=0.0)
    inputs = [rand(*s, seed=i) for i, s in enumerate(shapes)]
    ref, v, upd = apply_jax(jax_head(cfg), inputs, train=train)
    head = load(build_head(cfg), v).train(train)
    with torch.no_grad():
        out = head([nchw(x) for x in inputs])
    # the c1 skip fuses at the first level's size, else the input's
    level = shapes[-1] if name == 'sep-aspp' else shapes[0]
    assert out.shape[1:] == (2,) + level[1:3]
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if train:
        check_stats(head, upd)


def test_head_keys_are_mmsegs():
    cfg, _ = HEADS['psp']
    keys = set(build_head(cfg).state_dict())
    assert {'psp_modules.3.1.conv.weight', 'psp_modules.0.1.bn.running_var',
            'bottleneck.conv.weight', 'conv_seg.weight'} <= keys
    cfg, _ = HEADS['sep-aspp-c1']
    keys = set(build_head(cfg).state_dict())
    assert {'image_pool.1.conv.weight', 'aspp_modules.0.conv.weight',
            'aspp_modules.1.depthwise_conv.conv.weight',
            'aspp_modules.1.pointwise_conv.bn.weight',
            'c1_bottleneck.conv.weight',
            'sep_bottleneck.1.depthwise_conv.bn.running_mean'} <= keys
    with pytest.raises(AssertionError, match='pool_scales'):
        build_head(dict(HEADS['psp'][0], pool_scales=3))


# -- PSPNet and DeepLabv3+ ---------------------------------------------------

def tiny(config_cls, name, dropout=0.1):
    cfg = config_cls.fromfile(osp.join(REPO, 'my_config', f'{name}.py'))
    cfg.model.backbone.update(stem_channels=8, base_channels=8)
    cfg.model.decode_head.update(in_channels=256, channels=8,
                                 dropout_ratio=dropout)
    if name == 'DeepLabv3+':
        cfg.model.decode_head.update(c1_in_channels=32, c1_channels=4)
    cfg.model.test_cfg = dict(mode='whole')
    return cfg.to_dict()['model']


@pytest.fixture(scope='module', params=['PSPNet', 'DeepLabv3+'])
def config(request):
    jm, tm = mono.build_pair(tiny(JConfig, request.param), SIZE)
    return request.param, jm, tm


def test_every_flax_leaf_round_trips_through_the_bridge(config):
    """Each flax leaf lands on its own port key (plus a
    ``num_batches_tracked`` a BN), the key sets and the parameter counts
    are equal, and the inverse layout of each port tensor is the flax
    leaf, bit for bit."""
    name, jm, tm = config
    assert mono.check_leaves_and_count(jm, tm) > 0
    sd = tm.state_dict()
    for c in ('params', 'batch_stats'):
        for path, v in mono.leaves(jm.variables[c]):
            key, tag = translate_path(path, c)
            t = sd[key].numpy()
            back = np.transpose(t, (2, 3, 1, 0)) if tag == 'conv_w' else t
            np.testing.assert_array_equal(back, np.asarray(v), err_msg=key)
    want = {'PSPNet': 'decode_head.psp_modules.2.1.conv.weight',
            'DeepLabv3+': 'decode_head.c1_bottleneck.bn.running_mean'}
    assert want[name] in sd and 'backbone.layer4.2.conv3.weight' in sd


def test_logits_match_jax(config):
    _, jm, tm = config
    mono.check_logits(jm, tm, SIZE)


def test_train_steps_match_jax(config):
    """Three Adam steps as ``tests/fixtures/torch_monolithic.py`` holds
    them, but for the moves on the strong coordinates, which must agree on
    99 % of them, not all: the JAX f32 gradient of these 16 train-mode BN
    bottlenecks is itself 6.4 % (as a whole) off a float64 run of the
    port, against 0.37 % for the port's f32 gradient (PSPNet, first step),
    so Adam's first move, lr times the gradient's sign, turns the other
    way on 0.14 % (PSPNet) and 0.30 % (DeepLabv3+) of those coordinates
    in the first step, most of them in the first conv."""
    name, jm, _ = config
    cfg = tiny(Config, name, dropout=0.0)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt),
        min_agree=0.99)


@pytest.mark.parametrize('name,remat', [('PSPNet', True),
                                        ('DeepLabv3+', False)])
def test_config_trains_through_the_train_cli(name, remat, tmp_path):
    """The config through ``python -m stc_unet_tpu_torch.tools.train``'s
    ``main`` on the CPU at tiny widths (32² crops of 4 pseudo-KiTS pairs,
    one epoch of 2 steps, mDice after it), PSPNet with ``remat=True``:
    the work dir's checkpoint loads and predicts."""
    from stc_unet_tpu_torch.apis import init_segmentor
    from stc_unet_tpu_torch.tools.train import main
    root, work = str(tmp_path / 'data'), str(tmp_path / 'wd')
    write_split(root, 4, 32, seed=1)
    opts = ['model.backbone.stem_channels=8',
            'model.backbone.base_channels=8', 'model.decode_head.channels=8',
            'model.decode_head.in_channels=256',
            'data.train.pipeline.2.img_scale=(40,40)',
            'data.train.pipeline.3.crop_size=(32,32)',
            'data.train.pipeline.7.size=(32,32)',
            'data.val.pipeline.1.img_scale=(32,32)',
            'data.samples_per_gpu=2', 'data.workers_per_gpu=0',
            "log_config.hooks=[{'type': 'TextLoggerHook'}]",
            'runner.max_epochs=1', 'checkpoint_config.interval=1',
            "evaluation.metric=['mDice']", f'remat={remat}']
    if name == 'DeepLabv3+':
        opts += ['model.decode_head.c1_in_channels=32',
                 'model.decode_head.c1_channels=4']
    for split in ('train', 'val'):
        opts += [f'data.{split}.data_root={root}',
                 f'data.{split}.img_dir=test/images',
                 f'data.{split}.ann_dir=test/labels']
    main([osp.join(REPO, 'my_config', f'{name}.py'), '--device', 'cpu',
          '--work-dir', work, '--cfg-options', *opts])
    model = init_segmentor(osp.join(work, f'{name}.py'),
                           osp.join(work, 'latest.pth'), device='cpu')
    assert model.cfg.get('remat') is remat
    logits = model.encode_decode(mono.image(1, 32))
    assert logits.shape == (1, 32, 32, 2)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.slow
def test_pspnet_full_width_whole_parity_512():
    """``my_config/PSPNet.py`` at full width (ResNet-50, 64 stem and base
    channels, a 512-channel head), whole mode at 512², f32, to the limits
    of the full-width STC-UNet test (``tests/test_torch_stc_unet.py``):
    rtol 1e-4, atol 1e-4."""
    cfg = JConfig.fromfile(osp.join(REPO, 'my_config', 'PSPNet.py'))
    jm, tm = mono.build_pair(dict(cfg.to_dict()['model'],
                                  test_cfg=dict(mode='whole')), 512)
    img = mono.image(1, 512, seed=5)
    out = tm.encode_decode(img).numpy()
    ref = np.asarray(jm.encode_decode(img))
    assert out.shape == (1, 512, 512, 2)
    print(f'PSPNet whole 512: max abs error {np.abs(out - ref).max()}, '
          f'|max| {np.abs(ref).max()}')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
