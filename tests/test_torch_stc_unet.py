"""The port's STC-UNet inference against the JAX package, on the CPU.

Tiny widths (``__graft_entry__._flagship_cfg(tiny=True)``), parameters
from the JAX model's init with random BN running stats, carried into the
port by ``jax_to_torch_state``; images made with numpy from a seed. In
f32 the logits agree to rtol 1e-4 / atol 1e-5 (the precedent of
``tests/test_utils/test_torch_convert.py``): the two frameworks sum the
convolutions and attention in other orders.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SLIDE = dict(mode='slide', crop_size=(16, 16), stride=(8, 8))


def _jax_variables(jm, seed=0, size=32):
    """``jm.init_weights(seed)``'s variables, with the init jitted (one
    compile instead of one per op; the values are the same) and the BN
    running stats drawn at random so the eval BN is not the identity."""
    init = jax.jit(lambda rng, x: jm.net.init(
        {'params': rng, 'dropout': rng}, x, train=False,
        method=EncoderDecoderNet.forward_heads))
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)

    def stats(tree):
        return {k: stats(t) if hasattr(t, 'items') else (
            rng.uniform(-0.2, 0.2, t.shape) if k == 'mean'
            else rng.uniform(0.8, 1.2, t.shape)).astype(np.float32)
            for k, t in tree.items()}

    return {'params': jax.tree_util.tree_map(np.asarray, dict(v['params'])),
            'batch_stats': stats(v['batch_stats'])}


@pytest.fixture(scope='module')
def models():
    cfg = _flagship_cfg(tiny=True)
    jm = jax_build(cfg)
    jm.variables = _jax_variables(jm)
    tm = build_segmentor(cfg)
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    return jm, tm.to(memory_format=torch.channels_last)


def _img(n=2, size=32, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _metas(n, size):
    return [dict(ori_shape=(size, size, 3), img_shape=(size, size, 3),
                 pad_shape=(size, size, 3), flip=False) for _ in range(n)]


@pytest.mark.parametrize('mode', ['whole', 'slide'])
def test_logits_match_jax(models, mode):
    jm, tm = models
    img = _img()
    if mode == 'whole':
        ref = jm.encode_decode(img)
        out = tm.encode_decode(img)
    else:
        jm.test_cfg = tm.test_cfg = dict(SLIDE)
        ref = jm.slide_inference(img, None, False)
        out = tm.slide_inference(img, None, False)
    assert out.shape == (2, 32, 32, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_entry_point_matches_jax(models):
    """``model(return_loss=False, img=[batch], img_metas=[metas])`` →
    simple_test: softmax + argmax over slide logits."""
    jm, tm = models
    jm.test_cfg = tm.test_cfg = dict(SLIDE)
    img = _img(seed=1)
    ref = jm(return_loss=False, img=[img], img_metas=[_metas(2, 32)])
    out = tm(return_loss=False, img=[img], img_metas=[_metas(2, 32)])
    assert len(out) == 2 and out[0].shape == (32, 32)
    agree = np.mean(np.asarray(out) == np.asarray(ref))
    assert agree >= 0.999, agree


def test_aug_test_with_flip_and_rescale_matches_jax(models):
    """Two augmentations (the second flipped), each rescaled to another
    ``ori_shape``: ``aug_test`` averages the flipped-back probabilities."""
    jm, tm = models
    jm.test_cfg = tm.test_cfg = dict(mode='whole')
    img = _img(seed=3)
    metas = [[dict(m, ori_shape=(40, 36, 3), flip=flip,
                   flip_direction=direction) for m in _metas(2, 32)]
             for flip, direction in ((False, None), (True, 'horizontal'))]
    imgs = [img, np.ascontiguousarray(img[:, :, ::-1])]
    ref = jm(return_loss=False, img=imgs, img_metas=metas)
    out = tm(return_loss=False, img=imgs, img_metas=metas)
    assert out[0].shape == (40, 36)
    agree = np.mean(np.asarray(out) == np.asarray(ref))
    assert agree >= 0.999, agree
    probs = tm.inference(imgs[1], metas[1], True)
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jm.inference(imgs[1], metas[1], True)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('hw', [(32, 32), (37, 53), (16, 40), (9, 9)])
def test_slide_offsets_match_jax(models, hw):
    jm, tm = models
    for crop, stride in (((16, 16), (8, 8)), ((256, 256), (170, 170)),
                         ((12, 20), (5, 7))):
        jm.test_cfg = tm.test_cfg = dict(mode='slide', crop_size=crop,
                                         stride=stride)
        assert tm._slide_offsets(*hw) == jm._slide_offsets(*hw)


def test_bf16_image_follows_the_jax_dtype_flow(models):
    """Eval MHA keeps its in_proj f32, and bf16 @ f32 promotes: x4, x5 and
    the decoder run in f32 when the image is bf16."""
    jm, tm = models
    img = _img(n=1, seed=2)
    extract = jax.jit(lambda v, x: jm.net.apply(
        v, x, train=False, method=EncoderDecoderNet.extract))
    jf = [str(f.dtype) for f in extract(jm.variables,
                                        jnp.asarray(img, jnp.bfloat16))]
    tf = [str(f.dtype).replace('torch.', '') for f in
          tm.extract_feat(torch.from_numpy(img).bfloat16())]
    assert jf == tf == ['bfloat16'] * 3 + ['float32'] * 2
    assert tm.encode_decode(torch.from_numpy(img).bfloat16()).dtype == \
        torch.float32


def test_training_is_not_ported(models):
    """What of training is still not ported raises: a pixel sampler
    (OHEM) and the layer-decay optimizers; a mesh must be a device mesh
    or a process group (remat is ported: ``tests/test_torch_remat.py``).
    The train step itself is held to JAX's in ``test_torch_train_step.py``
    (on two ranks in ``test_torch_data_parallel.py``); here
    ``forward(return_loss=True)`` needs the labels and gives the loss
    dict."""
    from stc_unet_tpu_torch.core import build_optimizer
    from stc_unet_tpu_torch.engine import make_train_step
    _, tm = models
    with pytest.raises(TypeError, match='gt_semantic_seg'):
        tm(img=_img(n=1), img_metas=_metas(1, 32), return_loss=True)
    gt = np.zeros((1, 32, 32), np.int64)
    with torch.no_grad():
        losses = tm(img=_img(n=1), img_metas=_metas(1, 32),
                    gt_semantic_seg=gt)
    assert sorted(losses) == ['decode.acc_seg', 'decode.loss_bce',
                              'decode.loss_dice']
    head = tm.decode_head
    head.sampler = dict(type='OHEMPixelSampler')
    try:
        with pytest.raises(NotImplementedError, match='Slice E'):
            tm.compute_losses(_img(n=1), gt)
    finally:
        head.sampler = None
    with pytest.raises(NotImplementedError, match='Slice E'):
        build_optimizer(tm, dict(type='AdamW', lr=1e-3,
                                 constructor='LayerDecayOptimizerConstructor'))
    opt = build_optimizer(tm, dict(type='Adam', lr=1e-3))
    with pytest.raises(TypeError, match='DeviceMesh or a ProcessGroup'):
        make_train_step(tm, opt, mesh=object())
    assert not tm.training


def test_init_segmentor_builds_the_flagship_config():
    """The full-width config builds on the CPU with seeded weights; the
    default device is the card, which raises without CUDA."""
    from stc_unet_tpu_torch.apis import init_segmentor
    path = osp.join(REPO, 'my_config', 'STC-UNet.py')
    m = init_segmentor(path, device='cpu')
    assert not m.training and m.out_channels == 2
    assert m.decode_head.up1.ca.conv1.weight.shape == (256, 1024, 1, 1)
    assert m.backbone.aspp4.tr[3].ma.in_proj_weight.shape == (1536, 512)
    w0 = m.backbone.inc.conv.conv[0].weight.clone()
    m2 = init_segmentor(Config.fromfile(path), device='cpu')
    assert torch.equal(w0, m2.backbone.inc.conv.conv[0].weight)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            init_segmentor(path)


def _full_width_models():
    """``my_config/STC-UNet.py`` at full width in JAX, from its jitted
    init, and in the port with the same weights."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'STC-UNet.py'))
    cfg.model.pretrained = None
    jm = jax_build(cfg.model, test_cfg=cfg.get('test_cfg'))
    jm.variables = _jax_variables(jm, size=64)
    tm = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    return jm, tm.to(memory_format=torch.channels_last)


@pytest.mark.slow
def test_full_width_whole_parity_512():
    """Full width (``my_config/STC-UNet.py``) at 512², whole mode, f32."""
    jm, tm = _full_width_models()
    img = _img(n=1, size=512, seed=5)
    out = tm.encode_decode(img).numpy()
    ref = np.asarray(jm.encode_decode(img))
    print(f'whole 512: max abs error {np.abs(out - ref).max()}, '
          f'|max| {np.abs(ref).max()}')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_full_width_slide_parity_512():
    """Full width at 512², slide mode as the benchmark runs it (crop 256,
    stride 170: 9 tiles), f32, to the whole-mode limits."""
    jm, tm = _full_width_models()
    jm.test_cfg = tm.test_cfg = dict(mode='slide', crop_size=(256, 256),
                                     stride=(170, 170))
    img = _img(n=1, size=512, seed=6)
    out = tm.slide_inference(img, None, False).numpy()
    ref = np.asarray(jm.slide_inference(img, None, False))
    assert out.shape == (1, 512, 512, 2)
    print(f'slide 512: max abs error {np.abs(out - ref).max()}, '
          f'|max| {np.abs(ref).max()}')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def full_width_train_step(size):
    """One Adam step (poly lr) of ``my_config/STC-UNet.py`` at full width
    with the head's dropout off, on a B=2 f32 batch of ``size``² images,
    in the port against JAX's from the same weights
    (``tests/fixtures/torch_monolithic.py``): the log vars to rtol 1e-5,
    the BN running stats to rtol 1e-4 / atol 1e-5, every parameter
    within 2·lr, the moves of the coordinates whose gradient is at least
    1e-3 of the largest to lr/1000."""
    jm, _ = _full_width_models()
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'STC-UNet.py'))
    cfg.model.pretrained = None
    cfg.model.decode_head.dropout_ratio = 0.0
    cfg.model.test_cfg = cfg.get('test_cfg')
    mcfg = cfg.to_dict()['model']
    img, gt = mono.train_batch(size)
    return mono.check_train_steps(
        mcfg, img, gt, mono.jax_train_run(mcfg, jm.variables, img, gt,
                                          steps=1))


@pytest.mark.slow
def test_full_width_train_step_512():
    """``full_width_train_step`` at 512², B=2 (ROADMAP §3 item 3: the card
    is held to the CPU at 64², and this holds the CPU to JAX at full
    size)."""
    full_width_train_step(512)
