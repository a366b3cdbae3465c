"""The port's ResUNet, LinkNet and MultiResUnet (``EncoderDecoderFull``
over the fork's live heads) against the JAX package, on the CPU, at the
JAX test's sizes (``tests/test_models/test_extra_heads.py``): ResUNet at
``filters=[8, 16, 16, 16]`` and 32², LinkNet (its resnet18 widths are
fixed) at 64², MultiResUnet at ``filters=4`` and 32². Helpers and
tolerances: ``tests/fixtures/torch_monolithic.py`` (eval logits at rtol
1e-4 / atol 1e-5; three Adam steps in ``check_train_steps``' bands). The
full-width configurations are ``chip_smoke.py``'s ``FORK``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.decode_heads import extra_unet_heads as jex
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.decode_heads import extra_unet_heads as tex
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import random_variables
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

RESUNET = dict(type='ResUNet', filters=[8, 16, 16, 16], num_classes=2,
               channels=8, channel=1)
LINKNET = dict(type='LinkNet', n_classes=4, num_classes=4, channels=8)
MULTIRES = dict(type='MultiResUnet', filters=4, nclasses=2, num_classes=2,
                channels=3)


@pytest.fixture(scope='module')
def resunet():
    return mono.build_pair(mono.full_cfg(RESUNET), 32)


@pytest.fixture(scope='module')
def linknet():
    return mono.build_pair(mono.full_cfg(LINKNET), 64)


@pytest.fixture(scope='module')
def multires():
    return mono.build_pair(mono.full_cfg(MULTIRES), 32)


def _train(models, head, size, **kwargs):
    jm, _ = models
    cfg = mono.full_cfg(head)
    img, gt = mono.train_batch(size)
    return mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt),
        **kwargs)


# -- ResUNet ---------------------------------------------------------------

def test_resunet_leaves_map_to_port_keys(resunet):
    jm, tm = resunet
    assert mono.check_leaves_and_count(*resunet) == 50562
    sd = jax_to_torch_state(jm.variables, tm)
    # a brick ConvTranspose2d of in = out: (in, out, kh, kw), flipped
    k = np.asarray(jm.variables['params']['decode_head']['up1']['conv'][
        'kernel'])
    np.testing.assert_array_equal(
        sd['decode_head.up1.weight'].numpy(),
        np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
    assert sd['decode_head.out_conv.weight'].shape == (2, 8, 1, 1)
    assert 'decode_head.res1.skip_bn.running_var' in sd


def test_resunet_logits_match_jax(resunet):
    """The hard-wired 2-channel sigmoid output."""
    ref = mono.check_logits(*resunet, 32)
    assert ref.min() > 0 and ref.max() < 1


def test_resunet_train_steps_match_jax(resunet):
    _train(resunet, RESUNET, 32)


# -- LinkNet ---------------------------------------------------------------

def test_linknet_leaves_map_to_port_keys(linknet):
    jm, tm = linknet
    assert mono.check_leaves_and_count(*linknet) == 11533764
    sd = jax_to_torch_state(jm.variables, tm)
    assert sd['decode_head.decoder4.tp_conv.weight'].shape == (128, 128, 3, 3)
    assert sd['decode_head.tp_conv1.weight'].shape == (64, 32, 3, 3)
    assert sd['decode_head.tp_conv2.weight'].shape == (32, 4, 2, 2)
    assert 'decode_head.enc2_0.down_bn.running_mean' in sd
    assert 'decode_head.enc1_0.down_conv.weight' not in sd


def test_linknet_logits_match_jax(linknet):
    """The log-softmax output: probabilities summing to 1."""
    ref = mono.check_logits(*linknet, 64)
    np.testing.assert_allclose(np.exp(ref).sum(-1), 1.0, rtol=1e-5)


def test_linknet_train_steps_match_jax():
    """At 2 classes, the labels' and the full-width configuration's. With
    the 4 of the logit test, two classes the binary labels never hold put
    the largest gradient on their ``tp_conv2`` biases, and 6 % of the
    coordinates reach a thousandth of it, under the tenth
    ``check_train_steps`` holds to (65 % at 2 classes).

    As for the ResNet-50 models (``tests/test_torch_psp_aspp.py``), JAX's
    f32 gradient of the resnet18 encoder is itself off: 1.4 % of its norm
    from a float64 run of the port at ``in_conv``, where the port's f32
    one is 8.6e-6 off. Its sign then differs from the port's on a few
    strong coordinates (21 of ``in_conv``'s 9358), so the moves are held
    on 99 % of them (``min_agree``)."""
    head = dict(LINKNET, n_classes=2, num_classes=2)
    _train(mono.build_pair(mono.full_cfg(head), 64), head, 64,
           min_agree=0.99)


@pytest.mark.parametrize('cin,cout,k,s,p,op', [
    (16, 16, 3, 2, 1, 1), (16, 16, 3, 1, 1, 0), (16, 8, 3, 2, 1, 1)])
def test_link_decoder_matches_jax(cin, cout, k, s, p, op):
    """``_LinkDecoder`` at decoder4's stride 2 (output padding 1) and
    decoder1's stride 1, in eval and in training, BN stats included."""
    x = np.random.RandomState(cin + k).randn(2, 5, 6, cin).astype(np.float32)
    jmod = jex._LinkDecoder(cout, k, s, p, op)
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    mod = tex._LinkDecoder(cin, cout, k, s, p, op)
    for train in (False, True):
        mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
        out, upd = jax.jit(lambda v_, x_: jmod.apply(
            v_, x_, train=train, mutable=['batch_stats']))(v, x)
        mod.train(train)
        with torch.no_grad():
            got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(out), rtol=1e-5, atol=1e-5)
        assert got.shape[2:] == (5 * s, 6 * s)
        want = jax_to_torch_state({'batch_stats': jax.tree_util.tree_map(
            np.asarray, upd['batch_stats'])}, mod)
        for key, w in want.items():
            if key.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(mod.state_dict()[key].numpy(),
                                           w.numpy(), rtol=1e-5, atol=1e-6)


# -- MultiResUnet ----------------------------------------------------------

def test_multires_leaves_map_to_port_keys(multires):
    jm, tm = multires
    assert mono.check_leaves_and_count(*multires) == 106648
    sd = jax_to_torch_state(jm.variables, tm)
    # affine-free BNs: running stats only
    assert 'decode_head.multiresblock1.batch_norm1.weight' not in sd
    assert 'decode_head.multiresblock1.batch_norm1.running_mean' in sd
    # the shared Respath blocks: one set of weights each, none for length 1
    assert 'decode_head.respath1.conv2d_bn_3x3_common.conv1.weight' in sd
    assert not [k for k in sd if k.startswith('decode_head.respath4.') and
                'common' in k]
    assert sd['decode_head.upsample6.weight'].shape == (105, 32, 2, 2)


def test_multires_logits_match_jax(multires):
    mono.check_logits(*multires, 32)


def test_multires_train_steps_match_jax(multires):
    """Three Adam steps; every BN's ``num_batches_tracked`` counts each of
    its runs: twice a step for a Multiresblock's ``batch_norm1``, 1 + L
    for a Respath's, L for its common blocks'."""
    _train(multires, MULTIRES, 32, bn_calls=chip_smoke.multires_bn_calls)


@pytest.mark.parametrize('nclasses,head', [
    (1, dict(num_classes=2, out_channels=1, threshold=0.5)),
    (3, dict(num_classes=3))])
def test_multires_output_follows_nclasses(nclasses, head):
    """``nclasses`` output channels, through a sigmoid only when it is 1;
    the logits and the entry point's labels against JAX's."""
    cfg = mono.full_cfg(dict(MULTIRES, nclasses=nclasses, **head))
    jm, tm = mono.build_pair(cfg, 32)
    mono.check_leaves_and_count(jm, tm)
    img = mono.image(2, 32)
    ref = np.asarray(jm.encode_decode(img))
    out = tm.encode_decode(img).numpy()
    assert out.shape == (2, 32, 32, nclasses)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert (nclasses == 1) == bool(ref.min() > 0 and ref.max() < 1)
    metas = [dict(ori_shape=(32, 32, 3), img_shape=(32, 32, 3),
                  pad_shape=(32, 32, 3), flip=False)] * 2
    want = jm.simple_test(img, metas)
    got = tm(return_loss=False, img=[img], img_metas=[metas])
    assert np.mean(np.asarray(got) == np.asarray(want)) >= 0.999


@pytest.mark.parametrize('length', [1, 3])
def test_shared_bn_updates_match_jax(length):
    """A Multiresblock's one ``batch_norm1`` run twice and a Respath's
    shared blocks run ``length`` times (not ``length - 1``): the outputs
    and the running stats after one training forward against JAX's, whose
    shared flax modules update their stats once a call, and torch's
    counts of the calls."""
    x = np.random.RandomState(length).randn(2, 8, 8, 6).astype(np.float32)
    for jmod, mod, calls in (
            (jex.Multiresblock(4), tex.Multiresblock(6, 4),
             {'batch_norm1': 2}),
            (jex.Respath(5, length), tex.Respath(6, 5, length),
             {'batch_norm1': 1 + length if length > 1 else 1,
              'conv2d_bn_1x1_common.batchnorm': length,
              'conv2d_bn_3x3_common.batchnorm': length})):
        v = random_variables(jmod, jnp.asarray(x), seed=3)
        mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
        out, upd = jax.jit(lambda v_, x_, m=jmod: m.apply(
            v_, x_, train=True, mutable=['batch_stats']))(v, x)
        with torch.no_grad():
            got = mod.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(out), rtol=1e-5, atol=1e-5)
        want = jax_to_torch_state({'batch_stats': jax.tree_util.tree_map(
            np.asarray, upd['batch_stats'])}, mod)
        sd = mod.state_dict()
        for key, w in want.items():
            if key.endswith('num_batches_tracked'):
                name = key[:-len('.num_batches_tracked')]
                assert int(sd[key]) == calls.get(name, 1), key
            else:
                np.testing.assert_allclose(sd[key].numpy(), w.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize('filters', [4, 32])
def test_multires_widths_truncate_as_in_jax(filters):
    """``int`` truncation of each tower width: 51, 105, 212, 426 and 853
    at ``filters=32``."""
    widths = [tex.mrb_out_channels(filters * m) for m in (1, 2, 4, 8, 16)]
    assert widths == [jex.mrb_out_channels(filters * m)
                      for m in (1, 2, 4, 8, 16)]
    if filters == 32:
        assert widths == [51, 105, 212, 426, 853]


# -- the full-width configurations ------------------------------------------

@pytest.mark.parametrize('name', list(chip_smoke.FORK))
def test_full_width_config_has_the_jax_sizes(name):
    """``chip_smoke.FORK``'s configurations (``my_config/DC-UNet.py`` with
    the fork head) build through the port's ``HEADS`` in
    ``EncoderDecoderFull`` with the JAX model's parameter and BN
    running-stat counts (``jax.eval_shape`` of its init at 64²)."""
    cfg = chip_smoke.fork_cfg(Config, name)
    tm = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert type(tm.decode_head).__name__ == cfg.model.decode_head.type
    jm = jax_build(cfg.to_dict()['model'])
    shapes = jax.eval_shape(lambda k: jm.net.init(
        k, jnp.zeros((1, 64, 64, 3)), train=False,
        method=EncoderDecoderNet.forward_heads), jax.random.PRNGKey(0))
    count = {c: sum(int(np.prod(leaf.shape)) for leaf in
                    jax.tree_util.tree_leaves(shapes.get(c, {})))
             for c in ('params', 'batch_stats')}
    assert sum(p.numel() for p in tm.parameters()) == count['params']
    assert sum(b.numel() for k, b in tm.named_buffers()
               if k.endswith(('running_mean', 'running_var'))) == \
        count['batch_stats']
