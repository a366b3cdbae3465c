"""The port's ResNet, ResNetV1c and ResNetV1d backbones
(``stc_unet_tpu_torch/models/backbones/resnet.py``) against the JAX
package's, on the CPU, at ``stem_channels`` and ``base_channels`` 8 on a
33² image (odd, so every strided stage, the ceil-mode average pool of V1d
among them, meets a partial window; the shapes of
``tests/test_models/test_backbones/test_resnet.py`` otherwise).

The JAX variables are drawn with numpy in the shapes of the JAX init
(``tests/fixtures/torch_port.py``), the BN running stats included, and
carried into the port by ``jax_to_torch_state``. Tolerances, f32: every
output level at rtol 1e-4 / atol 1e-5 in eval (the STC-UNet precedent,
``tests/test_torch_stc_unet.py``). In training each BN divides by the
standard deviation of a batch of as few as 2·2² values a channel
(``E[x²] − E[x]²``, in both packages), which magnifies the convolutions'
f32 rounding block by block: after the 16 blocks of ResNet-50 the JAX
package's f32 output lies up to 5.9e-4 of the largest output from a
float64 run of the port, and the port's f32 output 1.2e-4. So training
holds each level to 1e-3 of its largest value (and rtol 1e-4), the
updated BN running stats to rtol 1e-4 / atol 1e-5 (``chip_smoke.py``'s
``train_check``), and one ``num_batches_tracked`` each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models import build_backbone as jax_backbone
from stc_unet_tpu_torch.models import build_backbone
from stc_unet_tpu_torch.models.bricks import BatchNorm
from stc_unet_tpu_torch.utils import jax_to_torch_state
from tests.fixtures.torch_port import random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 33
TINY = dict(stem_channels=8, base_channels=8)
OS8 = dict(strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
           contract_dilation=True)

# name: (config, train mode)
CASES = {
    'r18': (dict(type='ResNet', depth=18), False),
    'r18-os8-train': (dict(type='ResNet', depth=18, **OS8), True),
    'r50-os8': (dict(type='ResNet', depth=50, **OS8), False),
    'r50-os8-train': (dict(type='ResNet', depth=50, **OS8), True),
    'v1c-r50': (dict(type='ResNetV1c', depth=50), False),
    'v1d-r50-train': (dict(type='ResNetV1d', depth=50), True),
    'r50-caffe-multigrid': (dict(type='ResNet', depth=50, style='caffe',
                                 strides=(1, 2, 2, 1),
                                 dilations=(1, 1, 1, 2),
                                 multi_grid=(1, 2, 4)), False),
}


def image(n=2, size=SIZE, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def pair(cfg, seed=0):
    """(JAX module, its numpy-drawn variables, the port's module with
    them)."""
    cfg = dict(cfg, **TINY)
    jmod = jax_backbone(cfg)
    v = random_variables(jmod, jnp.asarray(image(1)), seed=seed)
    tm = build_backbone(cfg)
    tm.load_state_dict(jax_to_torch_state(v, tm), strict=True)
    return jmod, v, tm.to(memory_format=torch.channels_last)


@pytest.mark.parametrize('name', list(CASES))
def test_backbone_matches_jax(name):
    cfg, train = CASES[name]
    jmod, v, tm = pair(cfg)
    x = image()
    if train:
        ref, upd = jax.jit(lambda v_, x_: jmod.apply(
            v_, x_, train=True, mutable=['batch_stats']))(v, x)
    else:
        ref = jax.jit(jmod.apply)(v, x)
    tm.train(train)
    with torch.no_grad():
        outs = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(outs) == len(ref) == 4
    assert [o.shape[1] for o in outs] == tm.out_channels
    for o, r in zip(outs, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(
            o.permute(0, 2, 3, 1).numpy(), r, rtol=1e-4,
            atol=1e-3 * np.abs(r).max() if train else 1e-5)
    if train:
        stats = jax_to_torch_state(
            {'batch_stats': jax.tree_util.tree_map(np.asarray,
                                                   upd['batch_stats'])}, tm)
        sd = tm.state_dict()
        for k, want in stats.items():
            if k.endswith('num_batches_tracked'):
                assert int(sd[k]) == 1, k
            else:
                np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=k)


def test_keys_are_mmsegs():
    """The reference's ``state_dict`` keys: the plain stem's
    ``conv1``/``bn1``, the deep stem's ``stem.0`` to ``stem.7``, a
    shortcut's ``downsample.0``/``.1``, behind V1d's pool ``.1``/``.2``;
    the OS8 strides and dilations with ``contract_dilation``."""
    _, _, r50 = pair(CASES['r50-os8'][0])
    keys = set(r50.state_dict())
    assert {'conv1.weight', 'bn1.running_var', 'layer1.0.conv3.weight',
            'layer1.0.downsample.0.weight',
            'layer4.0.downsample.1.running_mean',
            'layer4.2.bn3.bias'} <= keys
    assert r50.out_channels == [32, 64, 128, 256]
    assert r50.layer3[0].conv2.dilation == (1, 1)     # 2, contracted
    assert r50.layer3[1].conv2.dilation == (2, 2)
    assert r50.layer4[0].conv2.dilation == (2, 2)     # 4, contracted
    assert r50.layer3[0].conv2.stride == (1, 1)
    _, _, v1d = pair(CASES['v1d-r50-train'][0])
    keys = set(v1d.state_dict())
    assert {'stem.0.weight', 'stem.4.running_mean', 'stem.7.weight',
            'layer2.0.downsample.1.weight',
            'layer2.0.downsample.2.running_var'} <= keys
    assert 'layer2.0.downsample.0.weight' not in keys
    _, _, caffe = pair(CASES['r50-caffe-multigrid'][0])
    assert caffe.layer2[0].conv1.stride == (2, 2)
    assert [b.conv2.dilation[0] for b in caffe.layer4] == [1, 2, 4]


@pytest.mark.parametrize('kwargs,error,match', [
    (dict(depth=26), KeyError, 'invalid depth'),
    (dict(num_stages=5, strides=(1,) * 5, dilations=(1,) * 5),
     AssertionError, 'num_stages'),
    (dict(strides=(1, 2, 2)), AssertionError, 'must match num_stages'),
    (dict(style='tf'), AssertionError, 'style'),
    (dict(pretrained=1), TypeError, 'pretrained'),
])
def test_construction_checks_match_jax(kwargs, error, match):
    """The JAX module's construction-time checks (``resnet.py:201-222``):
    the same error in both packages."""
    cfg = dict(type='ResNet', **kwargs)
    with pytest.raises(error, match=match):
        jax_backbone(cfg)
    with pytest.raises(error, match=match):
        build_backbone(cfg)


@pytest.mark.parametrize('kwargs', [dict(pretrained='r50.pth'),
                                    dict(dcn=dict(type='DCN')),
                                    dict(stage_with_dcn=(False, True) * 2),
                                    dict(plugins=[dict(cfg=None)])])
def test_what_is_not_ported_names_item_20(kwargs):
    with pytest.raises(NotImplementedError, match='item 20'):
        build_backbone(dict(type='ResNet', depth=18, **kwargs))


def test_norm_eval_frozen_stages_and_accepted_flags():
    """``norm_eval`` keeps every BN in eval in training (its running stats
    stay); ``frozen_stages=1`` freezes the stem and ``layer1`` (eval,
    ``requires_grad`` off: no gradient) and trains the rest;
    ``with_cp`` and ``zero_init_residual`` change nothing, as in JAX."""
    x = torch.from_numpy(image()).permute(0, 3, 1, 2)
    base = dict(type='ResNet', depth=18, **TINY)
    m = build_backbone(dict(base, norm_eval=True)).train()
    assert m.training and not any(b.training for b in m.modules()
                                  if isinstance(b, BatchNorm))
    before = m.bn1.running_mean.clone()
    m(x)
    assert torch.equal(m.bn1.running_mean, before)
    m = build_backbone(dict(base, frozen_stages=1)).train()
    frozen = [m.conv1, m.bn1, m.layer1]
    assert not any(mod.training for mod in frozen)
    assert m.layer2.training
    sum(o.sum() for o in m(x)).backward()
    for mod in frozen:
        assert all(not p.requires_grad and p.grad is None
                   for p in mod.parameters())
    assert all(p.grad is not None for p in m.layer2.parameters())
    assert int(m.layer1[0].bn1.num_batches_tracked) == 0
    ref = build_backbone(base)
    ref.load_state_dict(m.state_dict())
    for flags in (dict(with_cp=True), dict(zero_init_residual=False)):
        other = build_backbone(dict(base, **flags))
        other.load_state_dict(ref.state_dict())
        with torch.no_grad():
            for a, b in zip(other.eval()(x), ref.eval()(x)):
                assert torch.equal(a, b)
