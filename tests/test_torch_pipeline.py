"""The port's test pipeline and ``inference_segmentor`` against the JAX
package, on the CPU.

Each transform, ``MultiScaleFlipAug`` and ``collate`` gets the same input
in both packages and must give the same arrays and ``img_metas``, key by
key: exactly, except where ``Resize`` changes the size, where the port's
float32 bilinear (``utils/image.py``) may differ from cv2's fixed-point
one by one level. ``inference_segmentor`` runs the tiny flagship (JAX
variables drawn with numpy, ``conv_seg`` shifted so the classes split the
pixels) on a path and on an array, whole and slide, with and without flip
TTA: label maps agree on >= 0.999 of the pixels and probabilities to
rtol 1e-4 / atol 1e-5 (the precedent of ``tests/test_torch_stc_unet.py``).
"""
import os.path as osp
import sys
import warnings

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from stc_unet_tpu.apis import inference_segmentor as jax_inference
from stc_unet_tpu.datasets import DataLoader as JDataLoader
from stc_unet_tpu.datasets import EpochSampler as JEpochSampler
from stc_unet_tpu.datasets import PIPELINES as JPIPELINES
from stc_unet_tpu.datasets import collate as jax_collate
from stc_unet_tpu.datasets.pipelines import Compose as JCompose
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu.utils import image as jimage
from stc_unet_tpu_torch.apis import inference_segmentor, init_segmentor
from stc_unet_tpu_torch.datasets import (PIPELINES, DataLoader, EpochSampler,
                                         build_dataset, collate)
from stc_unet_tpu_torch.datasets.pipelines import Compose
from stc_unet_tpu_torch.utils import Config, image, jax_to_torch_state
from tests.fixtures.torch_port import (SLIDE, jax_variables, split_classes,
                                       tiny_config, write_split)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401


# -- image ops ----------------------------------------------------------------

@pytest.mark.parametrize('shape', [(37, 53, 3), (32, 32, 3), (1, 7), (9, 9)])
@pytest.mark.parametrize('size', [(32, 32), (600, 600), (53, 37), (1, 1),
                                  (100, 17), (17, 100)])
def test_imresize_against_cv2(shape, size):
    """'nearest' equal to cv2's INTER_NEAREST; 'bilinear' within one level
    of INTER_LINEAR, equal where the size does not change; float32 images
    within a few float32 ulps (rtol 1e-6, atol 1e-5): the two weightings
    round differently."""
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    for interp, flag in (('bilinear', cv2.INTER_LINEAR),
                         ('nearest', cv2.INTER_NEAREST)):
        got, want = image.imresize(img, size, interpolation=interp), \
            cv2.resize(img, size, interpolation=flag)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want).max()
        assert diff <= (1 if interp == 'bilinear' else 0)
        same = image.imresize(img, shape[1::-1], interpolation=interp)
        np.testing.assert_array_equal(same, img)
    f = img.astype(np.float32) / 7
    np.testing.assert_allclose(image.imresize(f, size), cv2.resize(f, size),
                               rtol=1e-6, atol=1e-5)
    assert image.imresize(img, size, return_scale=True)[1:] == \
        jimage.imresize(img, size, return_scale=True)[1:]


@pytest.mark.parametrize('scale', [0.5, 2, (512, 512), (600, 300), (40, 90)])
def test_rescale_matches_jax(scale):
    img = np.random.RandomState(1).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    assert image.rescale_size((53, 37), scale, True) == \
        jimage.rescale_size((53, 37), scale, True)
    got, factor = image.imrescale(img, scale, return_scale=True)
    want, jfactor = jimage.imrescale(img, scale, return_scale=True)
    assert got.shape == want.shape and factor == jfactor
    assert np.abs(got.astype(int) - want).max() <= 1


def test_flip_and_normalize_match_jax():
    img = np.random.RandomState(2).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    for d in ('horizontal', 'vertical', 'diagonal'):
        np.testing.assert_array_equal(image.imflip(img, d),
                                      jimage.imflip(img, d))
    mean, std = [1, 2, 3], [4, 5, 6]
    for to_rgb in (True, False):
        got = image.imnormalize(img, mean, std, to_rgb)
        np.testing.assert_array_equal(
            got, jimage.imnormalize(img, mean, std, to_rgb))
        np.testing.assert_array_equal(
            image.imdenormalize(got, mean, std, to_rgb),
            jimage.imdenormalize(got, mean, std, to_rgb))


# -- transforms, key by key ---------------------------------------------------

def _assert_same(got, want, path='', resized=False):
    """Equal trees; image arrays within one level where ``resized``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f'{path}/{k}', resized)
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float))):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f'{path}/{i}', resized)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and \
            got.shape == want.shape, (path, got.dtype, want.dtype)
        keys = [k for k in path.split('/') if k and not k.isdigit()]
        if resized and keys[-1:] == ['img']:
            assert np.abs(got.astype(np.float64) - want).max() <= 1, path
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('pipeline'))
    rng = np.random.RandomState(3)
    out = dict(bgr=osp.join(root, 'bgr.png'), gray=osp.join(root, 'g.png'),
               palette=osp.join(root, 'p.png'), label=osp.join(root, 'l.png'),
               label_rgb=osp.join(root, 'lrgb.png'),
               label_p=osp.join(root, 'lp.png'))
    cv2.imwrite(out['bgr'], rng.randint(0, 256, (37, 53, 3)).astype(np.uint8))
    Image.fromarray(rng.randint(0, 256, (37, 53)).astype(np.uint8)).save(
        out['gray'])
    p = Image.fromarray(rng.randint(0, 256, (37, 53)).astype(np.uint8), 'P')
    p.putpalette(list(rng.randint(0, 256, 768)))
    p.save(out['palette'])
    label = rng.randint(0, 4, (37, 53)).astype(np.uint8)
    label[:3] = 255
    Image.fromarray(label).save(out['label'])
    Image.fromarray(np.stack([label, label // 2, label], -1)).save(
        out['label_rgb'])
    lp = Image.fromarray(label, 'P')
    lp.putpalette(list(rng.randint(0, 256, 768)))
    lp.save(out['label_p'])
    return out


def _run(cfg, results):
    """The transform of ``cfg`` in both packages on copies of results."""
    def fresh():
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in results.items()}
    return PIPELINES.build(dict(cfg))(fresh()), \
        JPIPELINES.build(dict(cfg))(fresh())


@pytest.mark.parametrize('kind', ['bgr', 'gray', 'palette'])
@pytest.mark.parametrize('to_float32', [False, True])
def test_load_image_from_file_matches_jax(files, kind, to_float32):
    results = dict(img_prefix=osp.dirname(files[kind]),
                   img_info=dict(filename=osp.basename(files[kind])))
    got, want = _run(dict(type='LoadImageFromFile', to_float32=to_float32),
                     results)
    _assert_same(got, want)
    for kw in (dict(imdecode_backend='pillow'), dict(color_type='gray')):
        with pytest.raises(ValueError, match='not ported'):
            PIPELINES.build(dict(type='LoadImageFromFile', **kw))(
                dict(results))


def test_imwrite_matches_cv2(tmp_path):
    for x in (np.random.RandomState(4).randint(0, 256, (5, 7, 3)),
              np.random.RandomState(5).randint(0, 256, (5, 7))):
        x = x.astype(np.uint8)
        path = str(tmp_path / 'sub' / 'x.png')
        assert image.imwrite(x, path)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      x)


@pytest.mark.parametrize('kind', ['label', 'label_rgb', 'label_p'])
@pytest.mark.parametrize('reduce_zero_label', [False, True])
@pytest.mark.parametrize('label_map', [None, {0: 2, 2: 0, 3: 255}])
def test_load_annotations_matches_jax(files, kind, reduce_zero_label,
                                      label_map):
    results = dict(seg_prefix=None, seg_fields=[],
                   ann_info=dict(seg_map=files[kind]))
    if label_map is not None:
        results['label_map'] = label_map
    got, want = _run(dict(type='LoadAnnotations',
                          reduce_zero_label=reduce_zero_label), results)
    _assert_same(got, want)


def _loaded(files, seg=True):
    img = cv2.imread(files['bgr'])
    out = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
               pad_shape=img.shape, scale_factor=1.0, seg_fields=[])
    if seg:
        out['gt_semantic_seg'] = np.array(Image.open(files['label']))
        out['seg_fields'] = ['gt_semantic_seg']
    return out


@pytest.mark.parametrize('cfg,scale', [
    (dict(img_scale=(53, 37), keep_ratio=False), None),
    (dict(img_scale=(64, 32), keep_ratio=False), None),
    (dict(img_scale=(64, 32), keep_ratio=True), None),
    (dict(img_scale=(20, 90), keep_ratio=True, min_size=40), None),
    (dict(keep_ratio=False), (53, 37)),
    (dict(keep_ratio=False), (31, 77)),
    (dict(keep_ratio=True), (100, 100)),
])
def test_resize_matches_jax(files, cfg, scale):
    results = _loaded(files)
    if scale is not None:
        results['scale'] = scale
    got, want = _run(dict(type='Resize', **cfg), results)
    resized = want['img'].shape != results['img'].shape
    _assert_same(got, want, resized=resized)
    if not resized:
        np.testing.assert_array_equal(got['img'], results['img'])


def test_the_random_draws_raise():
    """A transform that must draw and is handed no generator
    (``results['rng']``) raises rather than take the global np.random."""
    results = dict(img=np.zeros((4, 4, 3), np.uint8), seg_fields=[])
    for cfg in (dict(img_scale=[(8, 8), (16, 16)]),
                dict(img_scale=[(8, 8), (16, 16)], multiscale_mode='value'),
                dict(img_scale=(8, 8), ratio_range=(0.5, 2.0))):
        with pytest.raises(ValueError, match='rng'):
            PIPELINES.build(dict(type='Resize', **cfg))(dict(results))
    with pytest.raises(ValueError, match='rng'):
        PIPELINES.build(dict(type='RandomFlip', prob=0.5))(dict(results))


@pytest.mark.parametrize('flip', [False, True])
@pytest.mark.parametrize('direction', ['horizontal', 'vertical'])
def test_random_flip_with_flip_set_matches_jax(files, flip, direction):
    results = dict(_loaded(files), flip=flip, flip_direction=direction)
    got, want = _run(dict(type='RandomFlip', prob=0.5), results)
    _assert_same(got, want)


@pytest.mark.parametrize('to_rgb', [False, True])
def test_normalize_and_formatting_match_jax(files, to_rgb):
    results = _loaded(files, seg=False)
    cfg = dict(type='Normalize', mean=[10.0, 20, 30], std=[2.0, 3, 4],
               to_rgb=to_rgb)
    got, want = _run(cfg, results)
    _assert_same(got, want)
    gray = dict(results, img=results['img'][..., 0])
    for cfg, res in ((dict(type='ImageToTensor', keys=['img']), results),
                     (dict(type='ImageToTensor', keys=['img']), gray),
                     (dict(type='Collect', keys=['img']), got),
                     (dict(type='Collect', keys=['img'],
                           meta_keys=('img_shape', 'missing')), got)):
        _assert_same(*_run(cfg, res))


# -- the test pipeline: MultiScaleFlipAug and collate -------------------------

AUGS = {
    'flagship': dict(scale=(53, 37)),
    'resized': dict(scale=(32, 32)),
    'flip': dict(scale=(53, 37), flip=True),
    'ratios': dict(scale=(32, 32), img_ratios=[0.5, 1.0, 1.5]),
    'own_shape': dict(scale=None, img_ratios=[1.0, 0.75]),
    'scales': dict(scale=[(53, 37), (40, 40)], flip=True),
}


@pytest.mark.parametrize('aug', sorted(AUGS))
def test_test_pipeline_and_collate_match_jax(files, aug):
    """The flagship's test pipeline (``_base_kits19.py:19-31``) with its
    ``MultiScaleFlipAug`` varied, over three images; then ``collate``."""
    pipes = []
    for config_cls, compose in ((Config, Compose), (JConfig, JCompose)):
        cfg = tiny_config(config_cls, **AUGS[aug])
        pipes.append(compose(cfg.data.test.pipeline))
    samples = [[], []]
    for path in (files['bgr'], files['gray'], files['palette']):
        results = dict(img_prefix=osp.dirname(path),
                       img_info=dict(filename=osp.basename(path)))
        for i, pipe in enumerate(pipes):
            samples[i].append(pipe(dict(results)))
    resized = aug not in ('flagship', 'flip')
    for got, want in zip(*samples):
        _assert_same(got, want, resized=resized)
    if aug in ('flagship', 'flip', 'ratios', 'resized'):
        _assert_same(collate(samples[0]), jax_collate(samples[1]),
                     resized=resized)
    plain = [{k: v[0] for k, v in s.items()} for s in samples[0]]
    _assert_same(collate(plain), jax_collate(plain))


def test_multi_scale_flip_aug_checks_its_config():
    t = [dict(type='Resize', keep_ratio=False)]
    for kw in (dict(img_scale=None), dict(img_scale=(8, 8), img_ratios=[1]),
               dict(img_scale=[[8, 8]])):
        with pytest.raises(ValueError):
            PIPELINES.build(dict(type='MultiScaleFlipAug', transforms=t, **kw))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        PIPELINES.build(dict(type='MultiScaleFlipAug', transforms=t,
                             img_scale=(8, 8), flip=True))
    assert 'RandomFlip' in str(w[0].message)


def test_dataset_wrappers_and_the_image_cache_raise(tmp_path):
    cfg = tiny_config(Config)
    test = cfg.data.test
    test.data_root = str(tmp_path)
    for bad in ([dict(test)], dict(type='RepeatDataset', dataset=test,
                                   times=2),
                dict(test, img_dir=['a', 'b'])):
        with pytest.raises(NotImplementedError, match='Item 20'):
            build_dataset(bad)
    # the image cache is ported: the loader takes it
    test.pipeline[0]['cache'] = 'ram'
    (tmp_path / 'test' / 'images').mkdir(parents=True)
    assert build_dataset(test).pipeline.transforms[0].cache.mode == 'ram'


# -- the loader ---------------------------------------------------------------

@pytest.mark.parametrize('n,shuffle,replicas,bs,drop_last', [
    (5, False, 1, 2, False), (5, True, 1, 2, False), (7, True, 2, 3, False),
    (7, False, 3, 2, True), (1, False, 1, 4, False), (64, True, 4, 4, False)])
def test_epoch_sampler_matches_jax(n, shuffle, replicas, bs, drop_last):
    for rank in range(replicas):
        for epoch in (0, 3):
            ours = EpochSampler(n, shuffle, 7, replicas, rank, bs, drop_last)
            theirs = JEpochSampler(n, shuffle, 7, replicas, rank, bs,
                                   drop_last)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours.indices(), theirs.indices())
            assert len(ours) == len(theirs)


def test_loader_batches_match_jax_with_many_threads(tmp_path):
    """The port's loader over a written split gives the JAX loader's
    batches, the last one padded, inline and with more threads than
    cores (the switch interval cut short)."""
    write_split(str(tmp_path), 7, 32)
    datasets = []
    for config_cls in (Config, JConfig):
        cfg = tiny_config(config_cls)
        cfg.data.test.update(data_root=str(tmp_path), test_mode=True)
        datasets.append(cfg.data.test)
    from stc_unet_tpu.datasets import build_dataset as jax_build_dataset
    ours, theirs = build_dataset(datasets[0]), jax_build_dataset(datasets[1])
    want = list(JDataLoader(theirs, 3, shuffle=False, num_workers=0))
    assert len(want) == 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for workers in (0, 2, 32):
            got = list(DataLoader(ours, 3, shuffle=False,
                                  num_workers=workers))
            _assert_same(got, want)
    finally:
        sys.setswitchinterval(interval)


# -- inference_segmentor ------------------------------------------------------

@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """(JAX segmentor, port segmentor, image paths): the tiny flagship
    with numpy-drawn variables, the classes split on the split's images."""
    root = str(tmp_path_factory.mktemp('infer'))
    paths = write_split(root, 2, 32)
    jm = jax_build(tiny_config(JConfig).model)
    jm.variables = jax_variables(jm)
    imgs = np.stack([cv2.imread(p)[..., ::-1] for p in paths]).astype(
        np.float32)
    split_classes(jm, imgs)
    tm = init_segmentor(tiny_config(Config), device='cpu')
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    return jm, tm, paths


@pytest.mark.parametrize('source', ['path', 'array'])
@pytest.mark.parametrize('mode', ['whole', 'slide'])
@pytest.mark.parametrize('flip', [False, True])
def test_inference_segmentor_matches_jax(models, source, mode, flip):
    jm, tm, paths = models
    jm.cfg, tm.cfg = tiny_config(JConfig, flip=flip), tiny_config(
        Config, flip=flip)
    jm.test_cfg = dict(SLIDE) if mode == 'slide' else dict(mode='whole')
    tm.test_cfg = dict(jm.test_cfg)
    imgs = paths if source == 'path' else [cv2.imread(p) for p in paths]
    got, want = inference_segmentor(tm, imgs), jax_inference(jm, imgs)
    assert len(got) == 2 and got[0].shape == (32, 32)
    agree = np.mean(np.stack(got) == np.stack(want))
    assert agree >= 0.999, agree
    one = inference_segmentor(tm, imgs[1])
    np.testing.assert_array_equal(one[0], got[1])
    # the probabilities of each augmentation, from the same batch
    pipeline = [dict(type='LoadImage')] + tm.cfg.data.test.pipeline[1:]
    data = collate([Compose(pipeline)(dict(img=p)) for p in imgs])
    assert len(data['img']) == (2 if flip else 1)
    for img, metas in zip(data['img'], data['img_metas']):
        probs = tm.inference(img, metas, True)
        assert probs.dtype == torch.float32
        np.testing.assert_allclose(probs.numpy(),
                                   np.asarray(jm.inference(img, metas, True)),
                                   rtol=1e-4, atol=1e-5)
    preds = np.stack(got)
    assert 0.1 < preds.mean() < 0.9, preds.mean()
