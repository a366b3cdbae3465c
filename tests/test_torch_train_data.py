"""The port's training data (``stc_unet_tpu_torch/utils/image.py``, the
train transforms, ``DefaultFormatBundle``, the samplers and the seeded
loader) against cv2 and the JAX package, on the CPU.

The image operations are held to cv2 bit for bit: ``imresize``'s bilinear
on uint8 at changed sizes (cv2's fixed-point ``INTER_LINEAR``),
``bgr2hsv`` over all 2^24 BGR values and ``hsv2bgr`` over every HSV
triple with H in [0, 180), through cv2's vector code and through its
scalar code. Each transform gets the same input in both
packages and the same draws: a ``RandomState(s)`` in ``results['rng']``
for the port, ``np.random.seed(s)`` before the JAX transform; results
must be equal key by key. The whole train pipeline of
``my_config/_base_kits19.py`` runs at its own sizes on 4 pseudo-KiTS
512² slices in both packages, each slice's draws seeded as the port's
loader seeds them (``sample_seed``), and must give identical ``img`` and
``gt_semantic_seg``.
"""
import cv2
import numpy as np
import pytest

from stc_unet_tpu.datasets import EpochSampler as JEpochSampler
from stc_unet_tpu.datasets import PIPELINES as JPIPELINES
from stc_unet_tpu.datasets import build_dataset as jax_dataset
from stc_unet_tpu.datasets.samplers import \
    DistributedSampler as JDistributedSampler
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu.utils import image as jimage
from stc_unet_tpu_torch.datasets import (PIPELINES, DistributedSampler,
                                         build_dataloader, build_dataset,
                                         sample_seed)
from stc_unet_tpu_torch.utils import Config, image
from tests.fixtures.torch_port import STC_CONFIG, write_split
from tests.fixtures.torch_threads import torch_threads  # noqa: F401


# -- image operations against cv2 ---------------------------------------------

@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('shape,size', [
    ((512, 512), (600, 600)), ((600, 600), (512, 512)),
    ((37, 53), (41, 29)), ((20, 7), (64, 100)), ((512, 512), (256, 256)),
    ((1, 5), (3, 1)), ((299, 131), (131, 299))])
def test_imresize_bilinear_uint8_is_cv2_bit_for_bit(shape, size, channels):
    """cv2's INTER_LINEAR on uint8 at changed sizes (up, down, by half,
    odd, one pixel), 1 and 3 channels: equal, with no remaining
    difference."""
    full = shape + (3,) if channels == 3 else shape
    img = np.random.RandomState(sum(shape)).randint(0, 256, full).astype(
        np.uint8)
    got = image.imresize(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _all_bgr():
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


def test_bgr2hsv_is_cv2_on_every_bgr_value():
    img = _all_bgr()
    np.testing.assert_array_equal(image.bgr2hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize('width', [256, 20])
def test_hsv2bgr_is_cv2_on_every_hsv_triple(width):
    """Rows of 256 pixels go through cv2's vector code only, rows of 20
    through its scalar code only (rows of 45 by 61, through both, in
    ``test_photometric_distortion_matches_jax``)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing='ij')
    img = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)
    np.testing.assert_array_equal(image.hsv2bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize('pad_val', [0, 7, 300, (1, 2, 3)])
def test_impad_matches_jax(pad_val):
    """cv2.copyMakeBorder's constant: a number fills the first channel
    (saturated), a tuple one value per channel."""
    rng = np.random.RandomState(3)
    for img in (rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
                rng.randint(0, 256, (5, 7)).astype(np.uint8),
                rng.rand(5, 7, 3).astype(np.float32)):
        if img.ndim == 2 and isinstance(pad_val, tuple):
            continue
        for kw in (dict(shape=(9, 8)), dict(shape=(3, 3)),
                   dict(padding=(1, 2, 3, 4)), dict(padding=2),
                   dict(padding=(1, 3))):
            got = image.impad(img, pad_val=pad_val, **kw)
            want = jimage.impad(img, pad_val=pad_val, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            image.impad_to_multiple(img, 4, pad_val=pad_val),
            jimage.impad_to_multiple(img, 4, pad_val=pad_val))


# -- each transform with the same draws ---------------------------------------

def _assert_same(got, want):
    got = {k: v for k, v in got.items() if k != 'rng'}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def _run(cfg, results, seed):
    ours = PIPELINES.build(dict(cfg))(
        dict(results, rng=np.random.RandomState(seed)))
    np.random.seed(seed)
    theirs = JPIPELINES.build(dict(cfg))(dict(results))
    return ours, theirs


def _sample(seed=0, size=(45, 61)):
    rng = np.random.RandomState(seed)
    gt = np.zeros(size, np.uint8)
    gt[size[0] // 3:, size[1] // 2:] = 1
    gt[:4] = 255
    return dict(img=rng.randint(0, 256, size + (3,)).astype(np.uint8),
                gt_semantic_seg=gt, seg_fields=['gt_semantic_seg'],
                img_shape=size + (3,), ori_shape=size + (3,),
                pad_shape=size + (3,), scale_factor=1.0)


@pytest.mark.parametrize('cfg', [
    dict(img_scale=[(40, 30), (80, 60)]),
    dict(img_scale=[(40, 30), (80, 60)], keep_ratio=False),
    dict(img_scale=[(40, 30), (80, 60), (64, 64)], multiscale_mode='value'),
    dict(img_scale=(64, 48), ratio_range=(0.5, 2.0)),
    dict(ratio_range=(0.75, 1.5), keep_ratio=False),
    dict(img_scale=(600, 600))])
def test_resize_draws_match_jax(cfg):
    for seed in range(4):
        _assert_same(*_run(dict(type='Resize', **cfg), _sample(seed), seed))


@pytest.mark.parametrize('direction', ['horizontal', 'vertical'])
def test_random_flip_draw_matches_jax(direction):
    flips = set()
    for seed in range(8):
        ours, theirs = _run(dict(type='RandomFlip', flip_ratio=0.5,
                                 direction=direction), _sample(seed), seed)
        _assert_same(ours, theirs)
        flips.add(ours['flip'])
    assert flips == {False, True}


@pytest.mark.parametrize('cat_max_ratio', [1.0, 0.75, 0.51])
def test_random_crop_matches_jax(cat_max_ratio):
    """At 0.75 and 0.51 most offsets are rejected (one class fills the
    crop) and the retries draw again."""
    for seed in range(6):
        _assert_same(*_run(dict(type='RandomCrop', crop_size=(20, 24),
                                cat_max_ratio=cat_max_ratio),
                           _sample(seed), seed))
    small = _sample(1, size=(10, 12))         # smaller than the crop
    _assert_same(*_run(dict(type='RandomCrop', crop_size=(20, 24)), small, 1))


def test_photometric_distortion_matches_jax():
    """Enough seeds to take each branch both ways and both contrast
    positions; the draws after each branch stay in step."""
    for seed in range(24):
        _assert_same(*_run(dict(type='PhotoMetricDistortion'),
                           _sample(seed), seed))


@pytest.mark.parametrize('cfg', [dict(size=(64, 80), pad_val=0),
                                 dict(size=(40, 50), seg_pad_val=7),
                                 dict(size_divisor=16, pad_val=3)])
def test_pad_and_format_bundle_match_jax(cfg):
    results = _sample(2)
    results['img'] = results['img'].astype(np.float32) / 3
    _assert_same(*_run(dict(type='Pad', **cfg), results, 0))
    _assert_same(*_run(dict(type='DefaultFormatBundle'), _sample(2), 0))


# -- the config's whole train pipeline ----------------------------------------

@pytest.fixture(scope='module')
def kits(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kits'))
    write_split(root, 4, 512, seed=4)
    return root


def _train_datasets(root):
    out = []
    for config_cls, build in ((Config, build_dataset),
                              (JConfig, jax_dataset)):
        train = config_cls.fromfile(STC_CONFIG).data.train
        train.update(data_root=root, img_dir='test/images',
                     ann_dir='test/labels')
        out.append(build(train))
    return out


def test_base_kits19_train_pipeline_matches_jax_bit_for_bit(kits):
    """600² Resize, 512² RandomCrop (cat_max_ratio 0.75), RandomFlip,
    PhotoMetricDistortion, Normalize, Pad, DefaultFormatBundle and
    Collect on 512² slices; two epochs' seeds per slice."""
    ours, theirs = _train_datasets(kits)
    for epoch in range(2):
        for i in range(len(ours)):
            seed = sample_seed(7, epoch, 0, i)
            got = ours.load(i, np.random.RandomState(seed))
            np.random.seed(seed)
            want = theirs[i]
            for key in ('img', 'gt_semantic_seg'):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f'{epoch} {i} {key}')
            assert got['img'].shape == (512, 512, 3)
            assert got['img_metas'].keys() == want['img_metas'].keys()
            assert got['img_metas']['flip'] == want['img_metas']['flip']


# -- samplers and the loader --------------------------------------------------

@pytest.mark.parametrize('replicas', [1, 2, 4])
@pytest.mark.parametrize('shuffle', [False, True])
def test_distributed_sampler_matches_jax(replicas, shuffle):
    """One rank's index stream, which the train loader draws its batches
    from: at batch size 1 the JAX ``DistributedSampler``'s, at batch size
    3 (padded, or cut with ``drop_last``) the JAX loader's
    ``EpochSampler``'s, for every rank and epoch."""
    for n in (10, 3):
        data = list(range(n))
        for rank in range(replicas):
            ours = DistributedSampler(data, replicas, rank, shuffle, seed=5)
            theirs = JDistributedSampler(data, replicas, rank, shuffle,
                                         seed=5)
            batched = [(DistributedSampler(data, replicas, rank, shuffle, 5,
                                           3, drop),
                        JEpochSampler(n, shuffle, 5, replicas, rank, 3, drop))
                       for drop in (False, True)]
            for epoch in range(3):
                ours.set_epoch(epoch)
                theirs.set_epoch(epoch)
                assert list(ours) == list(theirs)
                assert len(ours) == len(theirs)
                for a, b in batched:
                    a.set_epoch(epoch)
                    b.set_epoch(epoch)
                    assert list(a) == b.indices().tolist()
                    assert len(a) == len(b) * 3
    with pytest.raises(ValueError, match='rank'):
        DistributedSampler(data, 2, 2)


def _batches(dataset, workers, epoch, seed=3):
    loader = build_dataloader(dataset, samples_per_gpu=3,
                              workers_per_gpu=workers, shuffle=True,
                              seed=seed)
    loader.set_epoch(epoch)
    return list(loader), loader


def test_loader_batches_do_not_depend_on_workers(kits):
    """The same batches at 0 and 2 worker threads, for each epoch (4
    samples at 3 a batch: the last batch padded); each sample is its
    seeded rebuild; epochs differ; the global np.random is not drawn."""
    ours, _ = _train_datasets(kits)
    np.random.seed(11)
    state = np.random.get_state()
    epochs = []
    for epoch in range(2):
        inline, loader = _batches(ours, 0, epoch)
        threaded, _ = _batches(ours, 2, epoch)
        assert len(inline) == len(threaded) == 2
        for a, b in zip(inline, threaded):
            for key in ('img', 'gt_semantic_seg'):
                np.testing.assert_array_equal(a[key], b[key])
        order = loader.sampler.indices()
        for position, idx in enumerate(order[:3]):
            want = ours.load(int(idx), np.random.RandomState(
                sample_seed(3, epoch, 0, position)))
            np.testing.assert_array_equal(inline[0]['img'][position],
                                          want['img'])
        epochs.append(inline[0]['img'])
    assert not np.array_equal(epochs[0], epochs[1])
    assert all(np.array_equal(a, b) for a, b in
               zip(np.random.get_state()[1:], state[1:]))
    assert inline[0]['img'].dtype == np.float32
    assert inline[0]['gt_semantic_seg'].dtype == np.int64
