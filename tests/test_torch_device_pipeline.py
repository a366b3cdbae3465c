"""The port's train augmentation on the card
(``stc_unet_tpu_torch/datasets/device_pipeline.py``) against the JAX
package's (``stc_unet_tpu/datasets/device_pipeline.py``), on the CPU.

The port draws from a ``torch.Generator``, not from JAX's key stream. So
the JAX key splits (``device_pipeline.py:148``, ``:37``, ``:82``) are
replayed here with ``jax.random``, and the draws they give (crop offsets,
flip flags, the photometric deltas and masks) go to the port's apply
halves. Tolerances: crop, flip, labels and normalize exact; the
photometric step within 1e-4 absolute on the 0-255 scale (a few f32 ulps
of 255: XLA may fuse the multiply-adds and its ``cos``/``sin`` are its
own). Then the counterparts of ``tests/test_data/test_device_pipeline.py``,
the port's own draws, and the wiring through ``train_segmentor`` on the
tiny flagship. The card's half (the program on ``cuda``, the prefetch
stream) is ``chip_smoke.py``'s ``device_pipeline`` phase.
"""
import ast
import os
import os.path as osp
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.datasets import device_pipeline as jdp
from stc_unet_tpu_torch.datasets import (PIPELINES, DataLoader,
                                         DeviceBatchLoader, build_dataloader,
                                         build_dataset, collate,
                                         make_device_train_pipeline,
                                         split_train_pipeline,
                                         wrap_loader_with_device_pipeline)
from stc_unet_tpu_torch.datasets import device_pipeline as tdp
from stc_unet_tpu_torch.utils import png
from stc_unet_tpu_torch.utils.image import imnormalize
from tests.fixtures.torch_port import REPO
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

PHOTO_TOL = 1e-4           # absolute, on the 0-255 scale


def _batch(b=3, hw=(24, 28), seed=0):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (b,) + hw + (3,)).astype(np.uint8)
    gt = rs.randint(0, 3, (b,) + hw).astype(np.uint8)
    return img, gt


def _normalize(img, mean, std, to_rgb=True):
    """The program's normalize alone: no crop, flip or photometric step."""
    fn = make_device_train_pipeline(None, mean=mean, std=std, to_rgb=to_rgb,
                                    flip_prob=0.0, photo_metric=False)
    flip = torch.zeros(img.shape[0], dtype=torch.bool)
    return fn.apply(img, img[..., 0], dict(flip=flip))[0]


def _jax_crop_offsets(key, b, hw, crop, valid=None):
    """``random_crop``'s draws (``device_pipeline.py:37-46``)."""
    (h, w), (ch, cw) = hw, crop
    ky, kx = jax.random.split(key)
    if valid is None:
        return (np.asarray(jax.random.randint(ky, (b,), 0,
                                              max(h - ch, 0) + 1)),
                np.asarray(jax.random.randint(kx, (b,), 0,
                                              max(w - cw, 0) + 1)))
    valid = jnp.asarray(valid)
    ymax = jnp.maximum(valid[:, 0] - ch, 0)
    xmax = jnp.maximum(valid[:, 1] - cw, 0)
    return (np.asarray((jax.random.uniform(ky, (b,)) *
                        (ymax + 1)).astype(jnp.int32)),
            np.asarray((jax.random.uniform(kx, (b,)) *
                        (xmax + 1)).astype(jnp.int32)))


def _jax_photometric(key, b, brightness_delta=32.0, contrast_range=(0.5, 1.5),
                     saturation_range=(0.5, 1.5), hue_delta=18.0):
    """``photometric``'s draws (``device_pipeline.py:82-106``) under the
    port's keys; the hue angle in degrees (before its 2π/180)."""
    kb, kbm, kc, kcm, ks, ksm, kh, khm = jax.random.split(key, 8)
    shape = (b, 1, 1, 1)
    draws = dict(
        brightness=jax.random.uniform(kb, shape, minval=-brightness_delta,
                                      maxval=brightness_delta),
        do_brightness=jax.random.bernoulli(kbm, 0.5, shape),
        contrast=jax.random.uniform(kc, shape, minval=contrast_range[0],
                                    maxval=contrast_range[1]),
        do_contrast=jax.random.bernoulli(kcm, 0.5, shape),
        saturation=jax.random.uniform(ks, shape,
                                      minval=saturation_range[0],
                                      maxval=saturation_range[1]),
        do_saturation=jax.random.bernoulli(ksm, 0.5, shape))
    if hue_delta:
        draws.update(hue=jax.random.uniform(kh, (b, 1, 1), minval=-hue_delta,
                                            maxval=hue_delta),
                     do_hue=jax.random.bernoulli(khm, 0.5, shape))
    return {k: torch.from_numpy(np.array(v).reshape(b))
            for k, v in draws.items()}


def _jax_program_draws(key, b, hw, crop, valid, flip_prob, photo, pm):
    """``make_device_train_pipeline``'s draws (``:148``) in the port's
    ``fn.draw`` layout."""
    k1, k2, k3 = jax.random.split(key, 3)
    params = dict(flip=torch.from_numpy(np.array(
        jax.random.bernoulli(k2, flip_prob, (b,)))))
    if crop is not None:
        params['crop'] = tuple(torch.from_numpy(o.astype(np.int64)) for o in
                               _jax_crop_offsets(k1, b, hw, crop, valid))
    if photo:
        params['photometric'] = _jax_photometric(k3, b, **pm)
    return params


# -- each transform given JAX's draws -------------------------------------------
@pytest.mark.parametrize('valid', [False, True])
def test_crop_given_jax_draws_is_exact(valid):
    img, gt = _batch(4, (30, 26))
    hw_valid = np.array([[30, 26], [20, 26], [25, 18], [16, 16]], np.int32)
    key = jax.random.PRNGKey(11)
    ji, jg = jdp.random_crop(key, img.astype(np.float32), gt.astype(np.int32),
                             (16, 16), hw_valid if valid else None)
    offsets = _jax_crop_offsets(key, 4, (30, 26), (16, 16),
                                hw_valid if valid else None)
    ti, tg = tdp.apply_crop(torch.from_numpy(img), torch.from_numpy(gt),
                            offsets, (16, 16))
    np.testing.assert_array_equal(ti.numpy().astype(np.float32),
                                  np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize('direction', ['horizontal', 'vertical'])
def test_flip_given_jax_draws_is_exact(direction):
    img, gt = _batch(6, (9, 11))
    key = jax.random.PRNGKey(5)
    ji, jg = jdp.random_flip(key, img.astype(np.float32),
                             gt.astype(np.int32), 0.5, direction)
    flags = np.asarray(jax.random.bernoulli(key, 0.5, (6,)))
    assert 0 < flags.sum() < 6
    ti, tg = tdp.apply_flip(torch.from_numpy(img), torch.from_numpy(gt),
                            flags, direction)
    np.testing.assert_array_equal(ti.numpy().astype(np.float32),
                                  np.asarray(ji))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize('pm', [{}, dict(hue_delta=0.0),
                                dict(brightness_delta=60.0,
                                     contrast_range=(0.2, 2.5),
                                     saturation_range=(0.0, 2.0),
                                     hue_delta=40.0)],
                         ids=['default', 'no_hue', 'wide'])
def test_photometric_given_jax_draws_within_tolerance(pm):
    """Within ``PHOTO_TOL`` (1e-4 on the 0-255 scale) of JAX's
    ``photometric`` on the same draws; clipping lands both in [0, 255]."""
    rs = np.random.RandomState(1)
    img = (rs.rand(8, 12, 10, 3) * 255).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdp.photometric(key, img, **pm))
    got = tdp.apply_photometric(torch.from_numpy(img),
                                _jax_photometric(key, 8, **pm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PHOTO_TOL)
    assert got.min() >= 0 and got.max() <= 255
    assert np.abs(got - img).max() > 1.0       # the draws did something


@pytest.mark.parametrize('to_rgb', [True, False])
def test_normalize_is_exact(to_rgb):
    """Against JAX's ``normalize`` as its program compiles it (mean and
    std constants, so XLA multiplies by the reciprocal of std)."""
    img, _ = _batch(2, (5, 7))
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    want = np.asarray(jax.jit(lambda x: jdp.normalize(x, mean, std,
                                                      to_rgb))(img))
    got = _normalize(torch.from_numpy(img), mean, std, to_rgb).numpy()
    np.testing.assert_array_equal(got, want)


# -- the whole program given JAX's draws ------------------------------------------
@pytest.mark.parametrize('valid,photo', [(False, False), (True, False),
                                         (False, True), (True, True)],
                         ids=['plain', 'valid_hw', 'photo', 'valid_hw_photo'])
def test_program_given_jax_draws(valid, photo):
    """``fn.apply`` on the draws of JAX's key splits against the jitted
    JAX program: labels exact; the image exact without the photometric
    step, else within ``PHOTO_TOL / std``."""
    img, gt = _batch(4, (28, 30), seed=2)
    hw_valid = np.array([[28, 30], [20, 30], [28, 19], [17, 17]], np.int32)
    kw = dict(crop_size=(16, 16), mean=(10.0, 20.0, 30.0),
              std=(2.0, 3.0, 4.0), to_rgb=True, flip_prob=0.5,
              photo_metric=photo, photo_metric_cfg=dict(hue_delta=18.0))
    key = jax.random.PRNGKey(21)
    jfn = jdp.make_device_train_pipeline(**kw)
    ji, jg = jfn(key, img, gt, jnp.asarray(hw_valid) if valid else None)
    fn = make_device_train_pipeline(**kw)
    params = _jax_program_draws(key, 4, (28, 30), (16, 16),
                                hw_valid if valid else None, 0.5, photo,
                                kw['photo_metric_cfg'])
    ti, tg = fn.apply(torch.from_numpy(img), torch.from_numpy(gt), params)
    assert ti.dtype == torch.float32 and tg.dtype == torch.int64
    assert ti.shape == (4, 16, 16, 3) and tg.shape == (4, 16, 16)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    if photo:
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0,
                                   atol=PHOTO_TOL / 2.0)
    else:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# -- the counterparts of tests/test_data/test_device_pipeline.py ------------------
def test_shapes_and_determinism():
    img, gt = _batch(4, (40, 40))
    fn = make_device_train_pipeline((32, 32), mean=[0, 0, 0],
                                    std=[255, 255, 255])
    run = lambda s: fn(torch.Generator().manual_seed(s),  # noqa: E731
                       torch.from_numpy(img), torch.from_numpy(gt))
    out, out_gt = run(0)
    assert out.shape == (4, 32, 32, 3) and out_gt.shape == (4, 32, 32)
    assert float(out.max()) <= 1.0 + 1e-6
    assert torch.equal(out, run(0)[0])
    assert not torch.equal(out, run(1)[0])


def test_crop_keeps_image_and_labels_aligned():
    img = torch.arange(4 * 8 * 8).reshape(4, 8, 8, 1)
    offsets = tdp.draw_crop(torch.Generator().manual_seed(0), 4, (8, 8),
                            (4, 4))
    ci, cg = tdp.apply_crop(img, img[..., 0], offsets, (4, 4))
    assert torch.equal(ci[..., 0], cg)


def test_normalize_matches_the_host():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (8, 8, 3)).astype(np.float32)
    mean, std = [10, 20, 30], [2, 3, 4]
    host = imnormalize(img.copy(), mean, std, to_rgb=True)
    dev = _normalize(torch.from_numpy(img[None]), mean, std)[0].numpy()
    np.testing.assert_allclose(host, dev, rtol=1e-5)


KITS_PIPELINE = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations'),
    dict(type='Resize', img_scale=(600, 600)),
    dict(type='RandomCrop', crop_size=(512, 512), cat_max_ratio=0.75),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='PhotoMetricDistortion'),
    dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True),
    dict(type='Pad', size=(512, 512), pad_val=0, seg_pad_val=255),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_semantic_seg']),
]


def test_split_of_the_kits_pipeline_matches_jax():
    host_cfg, params = split_train_pipeline(KITS_PIPELINE)
    assert [c['type'] for c in host_cfg] == [
        'LoadImageFromFile', 'LoadAnnotations', 'Resize',
        'DeviceFormatBundle', 'Collect']
    assert host_cfg[3]['size'] == (600, 600)
    assert params['crop_size'] == (512, 512) and params['flip_prob'] == 0.5
    assert params['photo_metric'] is True and params['to_rgb'] is True
    assert (host_cfg, params) == jdp.split_train_pipeline(KITS_PIPELINE)


def test_split_rejects_what_it_cannot_express():
    with pytest.raises(ValueError, match='no device-expressible'):
        split_train_pipeline([dict(type='LoadImageFromFile'),
                              dict(type='Collect', keys=['img'])])
    bad = list(KITS_PIPELINE)
    bad.insert(4, dict(type='RandomRotate', prob=1.0, degree=30))
    with pytest.raises(ValueError, match='RandomRotate'):
        split_train_pipeline(bad)
    ratio = list(KITS_PIPELINE)
    ratio[2] = dict(type='Resize', img_scale=(600, 600),
                    ratio_range=(0.5, 2.0))
    with pytest.raises(ValueError, match='ratio_range'):
        split_train_pipeline(ratio)
    assert split_train_pipeline(ratio, host_size=(1200, 1200))[0][3][
        'size'] == (1200, 1200)
    pad = list(KITS_PIPELINE)
    pad[7] = dict(type='Pad', size=(256, 256))
    with pytest.raises(ValueError, match='Pad size'):
        split_train_pipeline(pad)


def test_device_format_bundle_pads_records_extent_and_collates():
    bundle = PIPELINES.build(dict(type='DeviceFormatBundle', size=(16, 20)))
    res = bundle(dict(img=np.ones((10, 12, 3), np.uint8) * 7,
                      gt_semantic_seg=np.ones((10, 12), np.uint8)))
    assert res['img'].shape == (16, 20, 3) and res['img'].dtype == np.uint8
    assert res['gt_semantic_seg'].shape == (16, 20)
    np.testing.assert_array_equal(res['valid_hw'], [10, 12])
    assert res['img'][12, 3, 0] == 0 and res['gt_semantic_seg'][12, 3] == 255
    other = bundle(dict(img=np.ones((16, 9, 3), np.uint8),
                        gt_semantic_seg=np.ones((16, 9), np.uint8)))
    batch = collate([res, other])
    assert batch['valid_hw'].shape == (2, 2)
    assert batch['valid_hw'].dtype == np.int32
    np.testing.assert_array_equal(batch['valid_hw'], [[10, 12], [16, 9]])
    assert batch['img'].shape == (2, 16, 20, 3)


def test_crop_stays_within_the_valid_extent():
    img = torch.zeros(6, 40, 40, 3, dtype=torch.uint8)
    gt = torch.full((6, 40, 40), 255, dtype=torch.uint8)
    gt[:, :24, :28] = 1
    valid = np.tile(np.array([[24, 28]], np.int32), (6, 1))
    for seed in range(5):
        offsets = tdp.draw_crop(torch.Generator().manual_seed(seed), 6,
                                (40, 40), (16, 16), valid)
        _, cg = tdp.apply_crop(img, gt, offsets, (16, 16))
        assert int(cg.max()) == 1, 'the crop reached the padding'


def test_program_matches_the_host_semantics():
    """Without the photometric step every output is the host's crop,
    flip and normalize of its sample at some offset and flag (within 1e-4:
    the host divides by std, the program multiplies by its reciprocal)."""
    rs = np.random.RandomState(3)
    img = rs.randint(0, 255, (3, 24, 24, 3), dtype=np.uint8)
    gt = rs.randint(0, 2, (3, 24, 24)).astype(np.uint8)
    mean, std = [5.0, 6.0, 7.0], [2.0, 3.0, 4.0]
    fn = make_device_train_pipeline((16, 16), mean=mean, std=std,
                                    photo_metric=False)
    out, out_gt = (t.numpy() for t in fn(torch.Generator().manual_seed(7),
                                         torch.from_numpy(img),
                                         torch.from_numpy(gt)))
    for b in range(3):
        matched = False
        for y0 in range(9):
            for x0 in range(9):
                for flipped in (False, True):
                    crop = img[b, y0:y0 + 16, x0:x0 + 16]
                    label = gt[b, y0:y0 + 16, x0:x0 + 16]
                    if flipped:
                        crop, label = crop[:, ::-1], label[:, ::-1]
                    ref = imnormalize(crop, mean, std, to_rgb=True)
                    if np.allclose(ref, out[b], rtol=0, atol=1e-4):
                        np.testing.assert_array_equal(label, out_gt[b])
                        matched = True
        assert matched, f'sample {b}: no crop and flip explains it'


def _write_pngs(root, n, size, seed=0):
    rs = np.random.RandomState(seed)
    for sub in ('img', 'ann'):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    for i in range(n):
        png.write(osp.join(root, 'img', f's{i}.png'),
                  rs.randint(0, 255, (size, size, 3)).astype(np.uint8))
        png.write(osp.join(root, 'ann', f's{i}.png'),
                  rs.randint(0, 2, (size, size)).astype(np.uint8))


def test_wrap_loader_end_to_end(tmp_path):
    """The dataset's pipeline becomes the host prefix and the loader
    yields finished batches on the device asked for (the CPU here)."""
    _write_pngs(str(tmp_path), 4, 40)
    pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations'),
        dict(type='Resize', img_scale=(48, 48)),
        dict(type='RandomCrop', crop_size=(32, 32)),
        dict(type='RandomFlip', flip_ratio=0.5),
        dict(type='Normalize', mean=[0, 0, 0], std=[255, 255, 255],
             to_rgb=True),
        dict(type='Pad', size=(32, 32)),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg']),
    ]
    ds = build_dataset(dict(type='CustomDataset', data_root=str(tmp_path),
                            img_dir='img', ann_dir='ann', img_suffix='.png',
                            seg_map_suffix='.png', classes=('bg', 'fg'),
                            palette=[[0, 0, 0], [1, 1, 1]],
                            pipeline=pipeline))
    loader = build_dataloader(ds, samples_per_gpu=2, workers_per_gpu=0,
                              dist=False, shuffle=True, seed=0)
    wrapped = wrap_loader_with_device_pipeline(loader, ds, pipeline, seed=0,
                                               device='cpu')
    assert isinstance(wrapped, DeviceBatchLoader)
    assert [type(t).__name__ for t in ds.pipeline.transforms][-2:] == [
        'DeviceFormatBundle', 'Collect']
    batches = list(wrapped)
    assert len(batches) == len(loader) == 2
    for batch in batches:
        img, gt = batch['img'], batch['gt_semantic_seg']
        assert img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
        assert gt.shape == (2, 32, 32) and gt.dtype == torch.int64
        assert float(img.abs().max()) <= 1.0 + 1e-6
        assert set(gt.unique().tolist()) <= {0, 1}
        np.testing.assert_array_equal(batch['valid_hw'], [[48, 48]] * 2)
    wrapped.set_epoch(1)
    assert loader.sampler.epoch == 1 and len(list(wrapped)) == 2


def test_host_size_follows_the_wh_scale_convention():
    pipe = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations'),
        dict(type='Resize', img_scale=[(100, 40), (80, 40)],
             keep_ratio=False, multiscale_mode='value'),
        dict(type='RandomCrop', crop_size=(32, 32)),
        dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1]),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg']),
    ]
    size = lambda p: next(c['size'] for c in split_train_pipeline(p)[0]  # noqa
                          if c['type'] == 'DeviceFormatBundle')
    assert size(pipe) == (40, 100)
    pipe[2] = dict(type='Resize', img_scale=(100, 40), keep_ratio=True)
    assert size(pipe) == (100, 100)
    pipe[3] = dict(type='RandomCrop', crop_size=(128, 16))
    assert size(pipe) == (128, 100)


def test_device_format_bundle_refuses_oversize():
    bundle = PIPELINES.build(dict(type='DeviceFormatBundle', size=(16, 16)))
    with pytest.raises(ValueError, match='exceeds the static host size'):
        bundle(dict(img=np.zeros((20, 10, 3), np.uint8)))


def test_split_carries_pad_values():
    pipe = list(KITS_PIPELINE)
    pipe[7] = dict(type='Pad', size=(512, 512), pad_val=128, seg_pad_val=0)
    bundle = next(c for c in split_train_pipeline(pipe)[0]
                  if c['type'] == 'DeviceFormatBundle')
    assert bundle['pad_val'] == 128 and bundle['seg_pad_val'] == 0


def test_hue_jitter_is_active_and_keeps_the_gray():
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.rand(4, 8, 8, 3).astype(np.float32) * 60 + 100)
    cfg = dict(brightness_delta=0.0, contrast_range=(1.0, 1.0),
               saturation_range=(1.0, 1.0))
    def jitter(hue_delta):
        params = tdp.draw_photometric(torch.Generator().manual_seed(3), 4,
                                      hue_delta=hue_delta, **cfg)
        return tdp.apply_photometric(img, params)

    out = jitter(18.0)
    assert not torch.allclose(out, img)
    torch.testing.assert_close(out.mean(-1), img.mean(-1), rtol=0,
                               atol=1e-3)
    out0 = jitter(0.0)
    torch.testing.assert_close(out0, img, rtol=0, atol=1e-4)


class _ListLoader:
    """A host loader's stand-in: fixed uint8 batches, in order."""

    def __init__(self, batches):
        self.batches = batches
        self.epoch = None

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        return iter(self.batches)


def _u8_batches(n=4, b=2, hw=16):
    rs = np.random.RandomState(0)
    return [dict(img=rs.randint(0, 255, (b, hw, hw, 3), dtype=np.uint8),
                 gt_semantic_seg=rs.randint(0, 2, (b, hw, hw)).astype(
                     np.uint8),
                 valid_hw=np.tile([hw, hw], (b, 1)).astype(np.int32),
                 img_metas=[{}] * b) for _ in range(n)]


_PARAMS = dict(crop_size=(8, 8), mean=(0., 0., 0.), std=(255., 255., 255.),
               flip_prob=0.5, photo_metric=True)


def _loader(batches, prefetch, **kw):
    return DeviceBatchLoader(_ListLoader(batches), _PARAMS, seed=0,
                             prefetch=prefetch, device='cpu', **kw)


def _equal_streams(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x['img'], y['img'])
        assert torch.equal(x['gt_semantic_seg'], y['gt_semantic_seg'])


def test_prefetch_stream_equals_the_synchronous_one():
    batches = _u8_batches()
    sync, pre = _loader(batches, 0), _loader(batches, 2)
    first = None
    for _ in range(2):            # the pass count goes on across passes
        got = list(sync)
        _equal_streams(got, list(pre))
        assert first is None or not torch.equal(first[0]['img'],
                                                got[0]['img'])
        first = got


def test_prefetch_thread_exits_on_an_abandoned_pass():
    loader = _loader(_u8_batches(n=8), 1)
    it = iter(loader)
    next(it)
    it.close()
    for _ in range(100):
        alive = [t for t in threading.enumerate()
                 if t.name == DeviceBatchLoader.THREAD_NAME and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, 'the feeder thread outlived its pass'


def test_an_abandoned_pass_does_not_shift_the_stream():
    batches = _u8_batches()
    ref = _loader(batches, 0)
    list(ref)
    want = list(ref)              # pass 1
    loader = _loader(batches, 2)
    it = iter(loader)
    next(it)                      # pass 0, abandoned
    it.close()
    _equal_streams(want, list(loader))


def test_the_epoch_keys_the_stream():
    """After ``set_epoch`` the pass is the epoch: a resumed run draws what
    the unbroken one drew, and a pass repeated in one epoch repeats."""
    batches = _u8_batches()
    unbroken = _loader(batches, 2)
    for epoch in range(3):
        unbroken.set_epoch(epoch)
        want = list(unbroken)
    resumed = _loader(batches, 0)
    resumed.set_epoch(2)
    _equal_streams(want, list(resumed))
    _equal_streams(want, list(resumed))
    assert unbroken.loader.epoch == 2


def test_host_errors_reraise_on_the_consumer_side():
    class Boom(_ListLoader):
        def __iter__(self):
            yield self.batches[0]
            raise RuntimeError('host decode failed')

    loader = DeviceBatchLoader(Boom(_u8_batches(n=2)), _PARAMS, prefetch=2,
                               device='cpu')
    with pytest.raises(RuntimeError, match='host decode failed'):
        list(loader)


def test_cuda_is_the_default_and_is_not_replaced():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises(RuntimeError, match='CUDA'):
        DeviceBatchLoader(_ListLoader([]), _PARAMS)


# -- the port's draws ----------------------------------------------------------------
def test_draws_keep_their_ranges_and_rates():
    g = torch.Generator().manual_seed(0)
    n = 20000
    valid = np.tile(np.array([[40, 24]], np.int32), (n, 1))
    y0, x0 = tdp.draw_crop(g, n, (64, 64), (16, 16), valid)
    assert y0.dtype == torch.int64 and y0.device.type == 'cpu'
    assert (int(y0.min()), int(y0.max())) == (0, 24)
    assert (int(x0.min()), int(x0.max())) == (0, 8)
    assert abs(float(y0.float().mean()) - 12.0) < 0.3
    y0, x0 = tdp.draw_crop(g, n, (20, 16), (16, 16))
    assert (int(y0.min()), int(y0.max())) == (0, 4) and int(x0.max()) == 0
    assert abs(float(tdp.draw_flip(g, n, 0.3).float().mean()) - 0.3) < 0.02
    p = tdp.draw_photometric(g, n)
    assert list(p) == list(tdp.PHOTOMETRIC_KEYS)
    for name, (lo, hi) in dict(brightness=(-32, 32), contrast=(0.5, 1.5),
                               saturation=(0.5, 1.5), hue=(-18, 18)).items():
        v = p[name]
        assert v.dtype == torch.float32 and lo <= float(v.min())
        assert float(v.max()) < hi
        assert float(v.min()) < lo + 0.05 * (hi - lo) and \
            float(v.max()) > hi - 0.05 * (hi - lo)
        assert abs(float(p[f'do_{name}'].float().mean()) - 0.5) < 0.02
    assert 'hue' not in tdp.draw_photometric(g, 4, hue_delta=0)


# -- train_segmentor --------------------------------------------------------------------
def _device_cfg(tmp_path):
    from stc_unet_tpu_torch.utils import Config
    from tests.fixtures.torch_port import tiny_config, write_split
    root = str(tmp_path / 'ds')
    write_split(root, 4, 32, seed=1)
    cfg = tiny_config(Config)
    pipe = cfg.data.train.pipeline
    pipe[2].img_scale = (40, 40)
    pipe[3].crop_size = (32, 32)
    pipe[7].size = (32, 32)
    cfg.data.update(samples_per_gpu=2, workers_per_gpu=0,
                    device_pipeline=True)
    cfg.data.train.update(data_root=root, img_dir='test/images',
                          ann_dir='test/labels')
    cfg.runner.max_epochs = 1
    cfg.log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
    cfg.work_dir = str(tmp_path / 'wd')
    cfg.seed = 0
    return cfg


def test_train_segmentor_trains_through_the_device_loader(tmp_path):
    """``data.device_pipeline=True`` on the tiny flagship (its own
    pipeline at 32² crops): the runner's loader is a
    ``DeviceBatchLoader``, each step takes its finished batch, and an
    epoch trains to a checkpoint."""
    from stc_unet_tpu_torch.apis import train_segmentor
    from stc_unet_tpu_torch.engine import HOOKS, Hook
    from stc_unet_tpu_torch.models import build_segmentor
    cfg = _device_cfg(tmp_path)
    seen = []

    class SeenBatches(Hook):
        def after_train_iter(self, runner):
            seen.append((runner.data_batch['img'],
                         runner.data_batch['gt_semantic_seg'],
                         runner.outputs['log_vars']['loss']))

    HOOKS.register_module(module=SeenBatches, force=True)
    cfg.custom_hooks = [dict(type='SeenBatches')]
    ds = build_dataset(cfg.data.train)
    model = build_segmentor(cfg.model)
    model.init_weights(seed=0)
    runner = train_segmentor(model, ds, cfg, device='cpu')
    assert isinstance(runner.data_loader, DeviceBatchLoader)
    assert runner.data_loader.device.type == 'cpu'
    assert runner.iter == len(runner.data_loader) == len(seen) == 2
    for img, gt, loss in seen:
        assert img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
        assert gt.dtype == torch.int64 and bool(torch.isfinite(loss))
    assert osp.exists(osp.join(cfg.work_dir, 'latest.pth'))
    # the same batches again from the loader: the stream is the epoch's
    again = list(runner.data_loader)
    assert torch.equal(again[0]['img'], seen[0][0])


def test_an_unexpressible_pipeline_warns_and_trains_on_the_host(tmp_path):
    from stc_unet_tpu_torch.apis import train_segmentor
    from stc_unet_tpu_torch.models import build_segmentor
    cfg = _device_cfg(tmp_path)
    cfg.data.train.pipeline[2] = dict(type='Resize', img_scale=(40, 40),
                                      ratio_range=(1.0, 1.25))
    ds = build_dataset(cfg.data.train)
    model = build_segmentor(cfg.model)
    model.init_weights(seed=0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        runner = train_segmentor(model, ds, cfg, device='cpu')
    assert any('device-expressible' in str(r.message) and
               'ratio_range' in str(r.message) for r in rec)
    assert isinstance(runner.data_loader, DataLoader)
    assert runner.iter == len(runner.data_loader)


# -- imports ----------------------------------------------------------------------------
def test_the_device_path_runs_without_jax_cv2_pillow_or_msgpack():
    """The card's machine has none of them: the device pipeline, its
    loader and the tools that drive it import and run with all blocked."""
    import subprocess
    import sys
    code = """
import sys
blocked = ('jax', 'jaxlib', 'flax', 'stc_unet_tpu', 'cv2', 'PIL', 'msgpack')
for name in blocked:
    sys.modules[name] = None
import numpy as np
from stc_unet_tpu_torch.datasets import DeviceBatchLoader
from stc_unet_tpu_torch.tools import parity_trained, profile_input  # noqa
rs = np.random.RandomState(0)
batch = dict(img=rs.randint(0, 255, (2, 12, 12, 3)).astype(np.uint8),
             gt_semantic_seg=np.zeros((2, 12, 12), np.uint8),
             valid_hw=np.full((2, 2), 12, np.int32))
loader = DeviceBatchLoader([batch], dict(crop_size=(8, 8),
                                         photo_metric=True),
                           device='cpu')
out = list(loader)
assert out[0]['img'].shape == (2, 8, 8, 3)
assert not [n for n in sys.modules if n.split('.')[0] in blocked and
            sys.modules[n] is not None]
print('ran without', blocked)
"""
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ran without' in proc.stdout


# -- the tools' device half --------------------------------------------------------
def test_the_tools_keep_the_jax_tools_configs_and_means(tmp_path):
    """``tools.parity_trained``'s config takes ``device_pipeline``;
    ``tools.profile_input`` has the JAX tool's five ``CONFIGS``; both
    tools' means over a JSON log follow the JAX tools' rule."""
    import json
    import runpy
    from stc_unet_tpu_torch.tools import parity_trained, profile_input
    from stc_unet_tpu_torch.utils import Config
    for device_pipeline in (False, True):
        path = str(tmp_path / f'cfg_{device_pipeline}.py')
        parity_trained.write_cfg(path, 'ds', 15, 8, save_every=15,
                                 save_optimizer=False,
                                 device_pipeline=device_pipeline)
        assert Config.fromfile(path).data.device_pipeline is device_pipeline
    profile_input.write_cfg(str(tmp_path / 'p.py'), 'ds', 6, 8, True,
                            'disk', str(tmp_path / 'c'))
    cfg = Config.fromfile(str(tmp_path / 'p.py'))
    assert (cfg.data.device_pipeline, cfg.data.img_cache) == (True, 'disk')
    with open(osp.join(REPO, 'tools', 'profile_input.py')) as f:
        tree = ast.parse(f.read())
    jax_configs = next(ast.literal_eval(n.value) for n in tree.body
                       if isinstance(n, ast.Assign) and
                       n.targets[0].id == 'CONFIGS')
    assert [tuple(c) for c in jax_configs] == profile_input.CONFIGS
    rs = np.random.RandomState(0)
    data, times = rs.rand(13).tolist(), rs.rand(13).tolist()
    with open(tmp_path / '1.log.json', 'w') as f:
        f.write(json.dumps(dict(env_info='x')) + '\n')
        for d, t in zip(data, times):
            f.write(json.dumps(dict(mode='train', data_time=d, time=t)) +
                    '\n')
        f.write(json.dumps(dict(mode='val', data_time=9.0)) + '\n')
    jax_tool = runpy.run_path(osp.join(REPO, 'tools', 'parity_trained.py'))
    mean = parity_trained.mean_log_value
    assert mean(str(tmp_path), 'data_time') == pytest.approx(
        jax_tool['mean_data_time'](str(tmp_path)), abs=1e-4)
    assert mean(str(tmp_path), 'data_time') == pytest.approx(
        np.mean(data[3:]), rel=1e-12)
    assert mean(str(tmp_path), 'time') == pytest.approx(
        np.mean(times[3:]), rel=1e-12)
