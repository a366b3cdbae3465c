"""The port's CARUnet (``EncoderDecoderFull`` + ``CARUnet``), its blocks
and CoordAtt's gate-only branch against the JAX package, on the CPU, at
32² (the JAX test's size, ``tests/test_models/test_extra_heads.py``; the
widths are CARUnet's own). Helpers and tolerances:
``tests/fixtures/torch_monolithic.py`` (eval logits at rtol 1e-4 / atol
1e-5; three Adam steps in ``check_train_steps``' bands).

On the CPU ``strip_pools`` is its plain version; the launch counts on the
card (K1 7 or 14 a forward, no K2) are ``chip_smoke.py``'s ``fork_*``
phases. Here the calls of the wrappers are counted instead."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.models.decode_heads import carunet_head as jcar
from stc_unet_tpu.models.decode_heads import unet_head as junet
from stc_unet_tpu_torch.models.decode_heads import carunet_head as tcar
from stc_unet_tpu_torch.models.decode_heads import unet_head as tunet
from stc_unet_tpu_torch.ops import coordatt_fused
from stc_unet_tpu_torch.utils import jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 32
VARIANTS = {'meca': {}, 'coordatt': dict(ca=True),
            'denseaspp': dict(denseaspp=True),
            'densecadrb': dict(densecadrb=True),
            'ca-dense': dict(ca=True, denseaspp=True, densecadrb=True)}
# parameters at 32² (the JAX init's), and K1 calls a forward
PARAMS = {'meca': 263592, 'coordatt': 256608, 'denseaspp': 1276072,
          'densecadrb': 291112, 'ca-dense': 1289624}
K1_CALLS = {'meca': 0, 'coordatt': 7, 'denseaspp': 0, 'densecadrb': 0,
            'ca-dense': 14}


def head(variant):
    return dict(type='CARUnet', num_classes=2, channels=16, in_channel=3,
                **VARIANTS[variant])


@pytest.fixture(scope='module', params=list(VARIANTS))
def variant(request):
    jm, tm = mono.build_pair(mono.full_cfg(head(request.param)), SIZE)
    return request.param, jm, tm


def test_leaves_map_to_port_keys(variant):
    name, jm, tm = variant
    assert mono.check_leaves_and_count(jm, tm) == PARAMS[name]
    sd = jax_to_torch_state(jm.variables, tm)
    assert sd['decode_head.conv_seg.weight'].shape == (2, 16, 1, 1)
    # ConvBlockDrop normalises its input: 3 channels in the first block
    assert sd['decode_head.cadrb_encoder1.conv1_1.bn.weight'].shape == (3,)
    gate = 'meca1' if VARIANTS[name].get('densecadrb') else 'meca'
    att = f'decode_head.cadrb_encoder2.{gate}.'
    if 'ca' in VARIANTS[name]:
        assert sd[att + 'conv_h.weight'].shape == (32, 8, 1, 1)
    else:
        assert sd[att + 'shared_conv.weight'].shape == (32, 32)
        assert sd[att + 'fc1.weight'].shape == (8, 32)
    if VARIANTS[name].get('denseaspp'):
        assert sd['decode_head.denseaspp_block.proj.weight'].shape == (
            64, 64 + 5 * 64, 1, 1)
    assert not [k for k in sd if 'attention_blcok' in k]


def test_logits_match_jax(variant):
    _, jm, tm = variant
    mono.check_logits(jm, tm, SIZE)


def test_coordatt_gates_call_k1_and_no_k2(variant, monkeypatch):
    """With ``ca`` each block's gate is CoordAtt's ``residual=False``
    branch: one ``strip_pools`` call a gate (7 a forward, 14 dense), no
    ``gate_add``; MecaBlock's blocks call neither."""
    name, _, tm = variant
    tm = copy.deepcopy(tm)
    calls = []
    strip = coordatt_fused.strip_pools
    monkeypatch.setattr(coordatt_fused, 'strip_pools',
                        lambda x: calls.append(x.shape) or strip(x))

    def no_k2(*args):
        raise AssertionError('gate_add called')

    monkeypatch.setattr(coordatt_fused, 'gate_add', no_k2)
    for train in (False, True):
        calls.clear()
        img = mono.image(2, SIZE)
        if train:
            tm.train().compute_losses(torch.from_numpy(img),
                                      torch.zeros(2, SIZE, SIZE,
                                                  dtype=torch.long))
        else:
            tm.eval().encode_decode(img)
        assert len(calls) == K1_CALLS[name]
    if name == 'coordatt':
        assert [tuple(s) for s in calls] == [
            (2, 32, 32, 16), (2, 16, 16, 32), (2, 8, 8, 64), (2, 4, 4, 64),
            (2, 8, 8, 32), (2, 16, 16, 16), (2, 32, 32, 16)]


@pytest.mark.parametrize('name', ['meca', 'ca-dense'])
def test_train_steps_match_jax(name):
    """``CARUnet()`` and ``CARUnet(ca=True, denseaspp=True,
    densecadrb=True)``: three Adam steps with the dropout off on both
    sides (the JAX run's flax ``Dropout`` patched to the identity, the
    port's rates set to 0)."""
    cfg = mono.full_cfg(head(name))
    jm, _ = mono.build_pair(cfg, SIZE)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


# -- the blocks --------------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _apply(jmod, mod, x, train, seed=1, **kwargs):
    """JAX module and port module on x (NHWC) from the same numpy-drawn
    variables: (JAX output, port output NHWC, JAX's updated batch stats,
    the port module)."""
    v = random_variables(jmod, jnp.asarray(x), train=False, seed=seed,
                         **kwargs)
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    out, upd = jax.jit(lambda v_, x_: jmod.apply(
        v_, x_, train=train, mutable=['batch_stats'], **kwargs))(v, x)
    mod.train(train)
    with torch.no_grad():
        got = mod(_nchw(x), **kwargs)
    return (np.asarray(out), got.permute(0, 2, 3, 1).numpy(),
            upd.get('batch_stats', {}), mod)


def _check_stats(mod, upd):
    want = jax_to_torch_state({'batch_stats': jax.tree_util.tree_map(
        np.asarray, upd)}, mod)
    sd = mod.state_dict()
    assert want
    for k, w in want.items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('shape', [(2, 9, 7, 16), (3, 6, 6, 64)])
def test_coordatt_gate_matches_jax(shape, train):
    """CoordAtt's ``residual=False`` branch returns the (N, C, H, W) gate
    ``a_h * a_w``, not added to x, against the JAX module's plain branch
    (``unet_head.py:84-85``), in eval and in training (its BN's stats
    too); the STC-UNet form, ``residual=True``, still adds x."""
    x = np.random.RandomState(shape[3]).randn(*shape).astype(np.float32)
    c = shape[3]
    for residual in (False, True):
        ref, got, upd, mod = _apply(junet.CoordAtt(c),
                                    tunet.CoordAtt(c, c), x, train,
                                    residual=residual)
        assert got.shape == shape
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        if train:
            _check_stats(mod, upd)
        if not residual:
            assert got.min() > 0 and got.max() < 1


@pytest.mark.parametrize('train', [False, True])
def test_meca_block_matches_jax(train):
    """The f32 mean and the max through one shared Linear, the c // 4
    bottleneck, the sigmoid: the (N, C, 1, 1) score."""
    x = np.random.RandomState(5).randn(2, 5, 7, 32).astype(np.float32)
    v = random_variables(jcar.MecaBlock(), jnp.asarray(x), seed=2)
    mod = tcar.MecaBlock(32)
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    ref = np.asarray(jax.jit(jcar.MecaBlock().apply)(v, x))
    with torch.no_grad():
        got = mod.train(train)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 1, 1, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('ca', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_blocks_match_jax(dense, ca, train):
    """CADRB and DenseCADRB with either gate, in eval and training (BN on
    the block's input channels; its stats after one forward)."""
    x = np.random.RandomState(7).randn(2, 8, 8, 12).astype(np.float32)
    jblock = (jcar.DenseCADRB if dense else jcar.CADRB)(16, ca=ca)
    block = (tcar.DenseCADRB if dense else tcar.CADRB)(12, 16, ca=ca)
    ref, got, upd, block = _apply(jblock, block, x, train)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if train:
        _check_stats(block, upd)


def test_dense_aspp_matches_jax():
    """Rates 3 to 24, each branch put before its input, the projection
    from ``in + 5·64``; eval (its dropout the identity)."""
    x = np.random.RandomState(9).randn(2, 6, 6, 64).astype(np.float32)
    ref, got, _, mod = _apply(jcar.DenseASPPBlock(), tcar.DenseASPPBlock(64),
                              x, False)
    assert got.shape == (2, 6, 6, 64)
    assert mod.proj.in_channels == 64 + 5 * 64
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_dense_aspp_dropout_draws_from_the_callers_generator():
    """Both dropouts draw their masks from the generator handed in:
    the same seed gives the same output, another seed another."""
    mod = tcar.DenseASPPBlock(8, 16, 4).train()
    x = torch.rand(2, 8, 5, 5)
    with torch.no_grad():
        a, b, c = (mod(x, torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('kernels', [(1, 3), (1, 3, 5, 7)])
def test_skattention_matches_jax(kernels, train):
    """SKAttention (not called by CARUnet): a conv + BN + relu branch a
    kernel, ``fc`` and ``fcs.{i}``, softmax over the branches."""
    x = np.random.RandomState(11).randn(2, 8, 8, 16).astype(np.float32)
    ref, got, upd, mod = _apply(jcar.SKAttention(kernels=kernels),
                                tcar.SKAttention(16, kernels), x, train)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert mod.fc.out_features == 32 and len(mod.fcs) == len(kernels)
    if train:
        _check_stats(mod, upd)
