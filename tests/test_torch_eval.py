"""The port's evaluation path against the JAX package, on the CPU: the
metrics, ``CustomDataset``/``MyDataset`` and ``single_gpu_test``.

The metrics and the dataset's tables are equal to JAX's. ``single_gpu_test``
runs the tiny flagship (JAX variables drawn with numpy, ``conv_seg``
shifted so the classes split the pixels) over 5 images at batch 2, so the
last batch is padded, with ``pre_eval=True`` and with ``format_only``.
Results are held to JAX's by the margin rule of ``chip_smoke.py``'s
``test_path``: a pixel whose JAX class margin lies within 1e-3 of the
margin's spread may take either label; elsewhere the labels agree, each
image's areas differ by no more than its excluded pixels, and mDice by no
more than the excluded pixels over the labelled ones. Last, the port's
test path runs in a process where cv2, Pillow, msgpack, jax, flax and the
JAX package cannot be imported, as on the card's machine.
"""
import os
import os.path as osp
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
from PIL import Image

from stc_unet_tpu.apis.test import single_gpu_test as jax_test
from stc_unet_tpu.core import evaluation as jev
from stc_unet_tpu.datasets import build_dataloader as jax_loader
from stc_unet_tpu.datasets import build_dataset as jax_dataset
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.apis import init_segmentor, single_gpu_test
from stc_unet_tpu_torch.core import evaluation as tev
from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures.torch_port import (REPO, jax_variables, split_classes,
                                       tiny_config, write_split)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

BAND = 1e-3


def _equal(got, want):
    """Equal trees of metric results (NaNs equal)."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- metrics ------------------------------------------------------------------

def _maps(seed, n=3, num_classes=4):
    rng = np.random.RandomState(seed)
    preds = [rng.randint(0, num_classes, (9, 11)) for _ in range(n)]
    labels = [rng.randint(0, num_classes + 1, (9, 11)).astype(np.uint8)
              for _ in range(n)]
    for lab in labels:
        lab[lab == num_classes] = 255
        lab[0, :3] = 0
    return preds, labels


@pytest.mark.parametrize('reduce_zero_label', [False, True])
@pytest.mark.parametrize('label_map', [None, {1: 2, 2: 1}, {3: 255}])
@pytest.mark.parametrize('ignore_index', [255, 0])
def test_intersect_and_union_matches_jax(reduce_zero_label, label_map,
                                         ignore_index):
    preds, labels = _maps(0)
    args = (4, ignore_index, label_map, reduce_zero_label)
    for p, lab in zip(preds, labels):
        _equal(tev.intersect_and_union(p, lab, *args),
               jev.intersect_and_union(p, lab, *args))
    _equal(tev.total_intersect_and_union(preds, labels, *args),
           jev.total_intersect_and_union(preds, labels, *args))


@pytest.mark.parametrize('metrics', [['mIoU'], ['mDice'], ['mFscore'],
                                     ['mIoU', 'mDice', 'mFscore']])
@pytest.mark.parametrize('nan_to_num', [None, -1])
@pytest.mark.parametrize('beta', [1, 2])
def test_eval_metrics_match_jax(metrics, nan_to_num, beta):
    preds, labels = _maps(1, num_classes=5)   # class 4 never labelled: NaN
    args = (6, 255)
    kw = dict(nan_to_num=nan_to_num, label_map={2: 5},
              reduce_zero_label=False, beta=beta)
    _equal(tev.eval_metrics(preds, labels, *args, metrics, **kw),
           jev.eval_metrics(preds, labels, *args, metrics, **kw))
    pre = [jev.intersect_and_union(p, lab, 6, 255)
           for p, lab in zip(preds, labels)]
    _equal(tev.pre_eval_to_metrics(pre, metrics, nan_to_num, beta),
           jev.pre_eval_to_metrics(pre, metrics, nan_to_num, beta))
    for name in ('mean_iou', 'mean_dice'):
        _equal(getattr(tev, name)(preds, labels, *args, nan_to_num),
               getattr(jev, name)(preds, labels, *args, nan_to_num))
    _equal(tev.mean_fscore(preds, labels, *args, beta=beta),
           jev.mean_fscore(preds, labels, *args, beta=beta))
    assert tev.f_score(0.3, 0.6, beta) == jev.f_score(0.3, 0.6, beta)
    with pytest.raises(KeyError):
        tev.eval_metrics(preds, labels, *args, ['mAP'])


def test_class_names_match_jax():
    for name, aliases in jev.class_names.dataset_aliases.items():
        for alias in aliases:
            for fn in ('get_classes', 'get_palette'):
                try:
                    want = getattr(jev, fn)(alias)
                except ValueError:
                    with pytest.raises(ValueError):
                        getattr(tev, fn)(alias)
                    continue
                assert getattr(tev, fn)(alias) == want
    with pytest.raises(ValueError):
        tev.get_classes('nowhere')


# -- the dataset --------------------------------------------------------------

@pytest.fixture(scope='module')
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('eval'))
    paths = write_split(root, 5, 32)
    with open(osp.join(root, 'some.txt'), 'w') as f:
        f.write('case_00003\ncase_00001\n')
    return root, paths


def _datasets(root, **kw):
    out = []
    for config_cls, build in ((Config, build_dataset),
                              (JConfig, jax_dataset)):
        cfg = tiny_config(config_cls)
        cfg.data.test.update(data_root=root, test_mode=True, **kw)
        out.append(build(cfg.data.test))
    return out


@pytest.mark.parametrize('kw', [dict(), dict(split='some.txt'),
                                dict(classes=['target']),
                                dict(reduce_zero_label=True)])
def test_dataset_matches_jax(split, kw):
    ours, theirs = _datasets(split[0], **kw)
    assert ours.img_infos == theirs.img_infos
    assert ours.CLASSES == theirs.CLASSES
    assert ours.PALETTE == theirs.PALETTE
    assert ours.label_map == theirs.label_map
    for a, b in zip(ours.get_gt_seg_maps(), theirs.get_gt_seg_maps()):
        np.testing.assert_array_equal(a, b)
    preds = [np.random.RandomState(i).randint(0, 2, (32, 32))
             for i in range(len(ours))]
    for metric in ('mIoU', ['mDice', 'mFscore']):
        _equal(ours.evaluate(preds, metric, logger='silent'),
               theirs.evaluate(preds, metric, logger='silent'))
        pre = ours.pre_eval(preds, list(range(len(ours))))
        _equal(pre, theirs.pre_eval(preds, list(range(len(theirs)))))
        _equal(ours.evaluate(pre, metric, logger='silent'),
               theirs.evaluate(pre, metric, logger='silent'))


# -- single_gpu_test ----------------------------------------------------------

@pytest.fixture(scope='module')
def models(split):
    root, paths = split
    jm = jax_build(tiny_config(JConfig).model)
    jm.variables = jax_variables(jm)
    imgs = np.stack([np.array(Image.open(p)) for p in paths]).astype(
        np.float32)
    split_classes(jm, imgs)
    tm = init_segmentor(tiny_config(Config), device='cpu')
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    logits = np.asarray(jm.encode_decode(imgs))
    return jm, tm, logits


def _loaders(root):
    return [build(d, samples_per_gpu=2, workers_per_gpu=2, dist=False,
                  shuffle=False)
            for d, build in zip(_datasets(root),
                                (build_dataloader, jax_loader))]


def test_single_gpu_test_pre_eval_matches_jax(split, models):
    jm, tm, logits = models
    ours, theirs = _loaders(split[0])
    assert len(ours) == len(theirs) == 3     # 5 images, the last batch padded
    margin = logits[..., 1] - logits[..., 0]
    excluded = np.abs(margin) <= BAND * margin.std()
    maps = single_gpu_test(tm, ours)
    want = jax_test(jm, theirs)
    assert len(maps) == len(want) == 5
    disagree = np.stack(maps) != np.stack(want)
    assert not (disagree & ~excluded).any()
    got_pre = single_gpu_test(tm, ours, pre_eval=True)
    want_pre = jax_test(jm, theirs, pre_eval=True)
    assert len(got_pre) == 5
    for g, w, k in zip(got_pre, want_pre, excluded.reshape(5, -1).sum(1)):
        assert np.abs(np.stack(g) - np.stack(w)).max() <= k
    dice = [np.nanmean(tev.pre_eval_to_metrics(p, ['mDice'])['Dice'])
            for p in (got_pre, want_pre)]
    labelled = sum(np.sum(w[3]) for w in want_pre)
    assert abs(dice[0] - dice[1]) <= excluded.sum() / labelled
    metrics = ['mIoU', 'mDice', 'mFscore']
    got_eval = ours.dataset.evaluate(got_pre, metrics, logger='silent')
    want_eval = theirs.dataset.evaluate(want_pre, metrics, logger='silent')
    if not disagree.any():
        _equal(got_eval, want_eval)
    assert 0.1 < np.stack(maps).mean() < 0.9


def test_single_gpu_test_format_only_matches_jax(split, models, tmp_path):
    jm, tm, logits = models
    ours, theirs = _loaders(split[0])
    margin = logits[..., 1] - logits[..., 0]
    excluded = np.abs(margin) <= BAND * margin.std()
    got = single_gpu_test(tm, ours, format_only=True, format_args=dict(
        imgfile_prefix=str(tmp_path / 'ours')))
    want = jax_test(jm, theirs, format_only=True, format_args=dict(
        imgfile_prefix=str(tmp_path / 'theirs')))
    assert [osp.basename(p) for p in got] == \
        [osp.basename(p) for p in want] == \
        [f'case_{i:05d}.png' for i in range(5)]
    for g, w, ex in zip(got, want, excluded):
        a, b = np.array(Image.open(g)), np.array(Image.open(w))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert not ((a != b) & ~ex).any()


def test_single_gpu_test_flags(split, models, tmp_path):
    _, tm, _ = models
    loader = _loaders(split[0])[0]
    with pytest.raises(ValueError, match='mutually exclusive'):
        single_gpu_test(tm, loader, pre_eval=True, format_only=True)
    with pytest.raises(NotImplementedError, match='window'):
        single_gpu_test(tm, loader, show=True)
    # out_dir paints each image with its label map (ported): 5 PNGs
    out_dir = osp.join(str(tmp_path), 'painted')
    maps = single_gpu_test(tm, loader, out_dir=out_dir)
    assert sorted(os.listdir(out_dir)) == [f'case_{i:05d}.png'
                                           for i in range(5)]
    painted = np.array(Image.open(osp.join(out_dir, 'case_00000.png')))
    assert painted.shape == (32, 32, 3) and painted.dtype == np.uint8
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        maps = single_gpu_test(tm, loader, efficient_test=True)
    assert any('efficient_test' in str(x.message) for x in w)
    assert len(maps) == 5 and maps[0].shape == (32, 32)


# -- the card machine's imports -----------------------------------------------

_BLOCKED = ('cv2', 'PIL', 'msgpack', 'jax', 'flax', 'stc_unet_tpu')

_SCRIPT = '''
import sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import numpy as np
from stc_unet_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                     single_gpu_test)
from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
from stc_unet_tpu_torch.utils import Config, png
root = {root!r}
rng = np.random.RandomState(0)
for d in ('images', 'labels'):
    import os
    os.makedirs(f'{{root}}/test/{{d}}')
for i in range(3):
    png.write(f'{{root}}/test/images/c{{i}}.png',
              rng.randint(0, 256, (32, 32, 3)).astype(np.uint8), i)
    png.write(f'{{root}}/test/labels/c{{i}}.png',
              (rng.rand(32, 32) > 0.5).astype(np.uint8))
cfg = Config.fromfile({config!r})
cfg.model.backbone.channel_list = [8, 16, 16, 16]
cfg.model.decode_head.channels = 8
cfg.model.decode_head.decoder_channel = [32, 32, 32, 32, 8]
cfg.data.test.pipeline[1].img_scale = (32, 32)
cfg.data.test.update(data_root=root, test_mode=True)
model = init_segmentor(cfg, device='cpu')
maps = inference_segmentor(model, f'{{root}}/test/images/c0.png')
assert maps[0].shape == (32, 32)
loader = build_dataloader(build_dataset(cfg.data.test), samples_per_gpu=2,
                          workers_per_gpu=2, dist=False, shuffle=False)
results = single_gpu_test(model, loader, pre_eval=True)
metrics = loader.dataset.evaluate(results, 'mDice', logger='silent')
assert len(results) == 3 and 'mDice' in metrics
blocked = [n for n in {blocked!r} if sys.modules.get(n) is not None]
loaded = [n for n in sys.modules if n.split('.')[0] in {blocked!r}
          and sys.modules[n] is not None]
assert not blocked and not loaded, (blocked, loaded)
print('ran without', {blocked!r})
'''


def test_the_test_path_runs_without_cv2_pillow_msgpack_or_jax(tmp_path):
    script = _SCRIPT.format(blocked=_BLOCKED, repo=REPO,
                            root=str(tmp_path / 'split'),
                            config=osp.join(REPO, 'my_config',
                                            'STC-UNet.py'))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', textwrap.dedent(script)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'ran without' in proc.stdout


def test_port_imports_no_cv2_pillow_or_msgpack():
    """The card's machine has none of them (the JAX side is held by
    ``tests/test_torch_boundary.py``)."""
    import ast
    files = sorted(osp.join(d, f) for d, _, fs in
                   os.walk(osp.join(REPO, 'stc_unet_tpu_torch'))
                   for f in fs if f.endswith('.py'))
    files.append(osp.join(REPO, 'chip_smoke.py'))
    # the train augmentation on the card and the tools that drive it
    assert {osp.join(REPO, 'stc_unet_tpu_torch', *rel) for rel in (
        ('datasets', 'device_pipeline.py'), ('tools', 'parity_trained.py'),
        ('tools', 'profile_input.py'))} <= set(files)
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and
                     node.level == 0 else [])
            bad += [(path, n) for n in names
                    if n.split('.')[0] in ('cv2', 'PIL', 'msgpack')]
    assert len(files) > 30 and not bad, bad
