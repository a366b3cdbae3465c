"""The port's test CLI (``python -m stc_unet_tpu_torch.tools.test``), its
``show_result``, the decoded-image cache and the extra hooks, against the
JAX package on the CPU.

Both CLIs run in this process on one tiny flagship checkpoint: a JAX
``.ckpt`` of variables drawn with numpy (``conv_seg`` shifted so the
classes split the pixels), which the port loads through
``jax_to_torch_state``. The JAX CLI runs as
``tests/test_tools/test_analysis_tools.py`` runs it, with the JAX model's
``init_weights`` drawing its variables with numpy instead of compiling
its init (the checkpoint replaces them). On the same argv the two give
the same metrics JSON (keys, values within 1e-6), the same ``--out``
pickle (the ``pre_eval`` areas: the CLI's default ``--eval`` makes every
run a ``pre_eval`` one), formatted results (``--eval cityscapes``) and
``--show-dir`` images with equal pixels, single-scale on 3 images and
with ``--aug-test`` on 2. The labels are compared exactly: the fixture
is checked to hold no pixel whose class margin lies within 1e-4 of the
margin's spread, where the two packages' rounding could part them. Last,
the port's CLI runs in a process where cv2, Pillow, msgpack, jax, the
JAX package, tensorboard and wandb cannot be imported, as on the card's
machine, after every module of the port is imported there.
"""
import json
import os
import os.path as osp
import pickle
import runpy
import shutil
import subprocess
import sys
import textwrap
import types

import cv2
import numpy as np
import pytest
from PIL import Image

from stc_unet_tpu.datasets import inject_img_cache as jax_inject
from stc_unet_tpu.engine import save_checkpoint as jax_save
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import \
    EncoderDecoder as JEncoderDecoder
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.datasets import build_dataset, inject_img_cache
from stc_unet_tpu_torch.datasets.pipelines import (LoadAnnotations,
                                                   LoadImageFromFile)
from stc_unet_tpu_torch.datasets.pipelines.img_cache import clear_ram_cache
from stc_unet_tpu_torch.engine import (EpochBasedRunner, MMSegWandbHook,
                                       TorchProfilerHook)
from stc_unet_tpu_torch.core import build_optimizer
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.tools import test as port_cli
from stc_unet_tpu_torch.utils import Config
from tests.fixtures.torch_port import (REPO, STC_CONFIG, jax_variables,
                                       split_classes, tiny_config,
                                       write_split)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SCALE = 'data.test.pipeline.1.img_scale=(32,32)'
PALETTE = [[0, 0, 0], [255, 64, 0]]


def _run_jax(argv):
    """``tools/test.py`` on ``argv`` in this process."""
    old = sys.argv
    sys.argv = ['tools/test.py'] + [str(a) for a in argv]
    init = JEncoderDecoder.init_weights
    JEncoderDecoder.init_weights = \
        lambda self, seed=0: setattr(self, 'variables', jax_variables(self))
    try:
        runpy.run_path(osp.join(REPO, 'tools', 'test.py'),
                       run_name='__main__')
    finally:
        JEncoderDecoder.init_weights = init
        sys.argv = old


def _run_both(base, argv, tag):
    """Both CLIs on ``argv``, each with its own work dir and output paths
    (``{out}`` in an argument becomes the side's directory)."""
    dirs = {}
    for side, run in (('jax', _run_jax),
                      ('port', lambda a: port_cli.main(
                          [str(x) for x in a] + ['--device', 'cpu']))):
        out = base / f'{tag}_{side}'
        out.mkdir()
        run([a.replace('{out}', str(out)) for a in argv] +
            ['--work-dir', str(out / 'wd')])
        dirs[side] = out
    return dirs


def _inputs(root):
    """The split's images as the test pipeline hands them to the model."""
    test = tiny_config(Config).data.test
    test.update(data_root=root, test_mode=True)
    ds = build_dataset(test)
    return np.stack([ds[i]['img'][0] for i in range(len(ds))])


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    """Two splits (3 and 2 images, 32²), the tiny config file and the JAX
    checkpoint."""
    base = tmp_path_factory.mktemp('cli')
    write_split(str(base / 'three'), 3, 32, seed=3)
    write_split(str(base / 'two'), 2, 32, seed=4)
    cfg = base / 'tiny.py'
    cfg.write_text(textwrap.dedent(f'''
        _base_ = [{STC_CONFIG!r}]
        model = dict(backbone=dict(channel_list=[8, 16, 16, 16]),
                     decode_head=dict(channels=8,
                                      decoder_channel=[32, 32, 32, 32, 8]))
        data = dict(workers_per_gpu=0)
        '''))
    jm = jax_build(tiny_config(JConfig).model)
    jm.variables = jax_variables(jm)
    split_classes(jm, _inputs(str(base / 'three')))
    ckpt = base / 'tiny.ckpt'
    jax_save(str(ckpt), jm.variables, step=4,
             meta=dict(CLASSES=['background', 'target'], PALETTE=PALETTE))
    return dict(base=base, cfg=str(cfg), ckpt=str(ckpt), jm=jm,
                three=str(base / 'three' / 'test' / 'images'),
                two=str(base / 'two' / 'test' / 'images'))


@pytest.fixture(scope='module')
def single(env):
    return _run_both(env['base'], [
        env['three'], env['cfg'], env['ckpt'], '--eval', 'mIoU', 'mDice',
        '--out', '{out}/out.pkl', '--show-dir', '{out}/vis',
        '--cfg-options', SCALE], 'single')


def _metrics(out):
    files = os.listdir(out / 'wd')
    assert len(files) == 1 and files[0].startswith('eval_')
    with open(out / 'wd' / files[0]) as f:
        return files[0].split('_2')[0], json.load(f)


def _assert_metrics_equal(dirs):
    (jname, jrec), (tname, trec) = _metrics(dirs['jax']), \
        _metrics(dirs['port'])
    assert jname == tname and list(trec) == list(jrec) == ['config',
                                                           'metric']
    assert list(trec['metric']) == list(jrec['metric'])
    np.testing.assert_allclose(list(trec['metric'].values()),
                               list(jrec['metric'].values()), rtol=0,
                               atol=1e-6)
    pkl = [pickle.load(open(dirs[s] / 'out.pkl', 'rb'))
           for s in ('port', 'jax')]
    assert len(pkl[0]) == len(pkl[1])
    for got, want in zip(*pkl):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    return trec['metric']


def test_fixture_has_no_near_ties(env):
    """Exact comparisons need every pixel's class margin clear of 0 by
    more than the two packages' rounding; the classes split the pixels."""
    logits = np.asarray(env['jm'].encode_decode(
        _inputs(osp.dirname(osp.dirname(env['three'])))))
    margin = logits[..., 1] - logits[..., 0]
    assert np.abs(margin).min() > 1e-4 * margin.std()
    assert 0.1 < (margin > 0).mean() < 0.9


def test_metrics_json_and_out_match_jax(single):
    metric = _assert_metrics_equal(single)
    assert 0 < metric['mDice'] < 100


def test_show_dir_pixels_match_jax(single):
    names = sorted(os.listdir(single['jax'] / 'vis'))
    assert names == sorted(os.listdir(single['port'] / 'vis')) == \
        [f'case_{i:05d}.png' for i in range(3)]
    for name in names:
        a, b = (cv2.imread(str(single[s] / 'vis' / name))
                for s in ('port', 'jax'))
        assert a.shape == (32, 32, 3)
        np.testing.assert_array_equal(a, b)


def test_format_results_match_jax(env):
    """``--eval cityscapes`` formats (``--format-only`` with the default
    ``--eval`` raises in both CLIs)."""
    argv = [env['three'], env['cfg'], env['ckpt'], '--cfg-options', SCALE]
    for run in (_run_jax, lambda a: port_cli.main(a + ['--device', 'cpu'])):
        with pytest.raises(ValueError, match='format_only'):
            run(argv + ['--format-only'])
    dirs = _run_both(env['base'], argv + [
        '--eval', 'cityscapes', '--eval-options', 'imgfile_prefix={out}/fmt'],
        'format')
    names = sorted(os.listdir(dirs['jax'] / 'fmt'))
    assert names == sorted(os.listdir(dirs['port'] / 'fmt')) and \
        len(names) == 3
    for name in names:
        a, b = (np.array(Image.open(dirs[s] / 'fmt' / name))
                for s in ('port', 'jax'))
        assert a.dtype == np.uint8 and a.shape == (32, 32)
        np.testing.assert_array_equal(a, b)
        assert not os.listdir(dirs['port'] / 'wd')     # no metrics


def test_aug_test_matches_jax(env):
    dirs = _run_both(env['base'], [
        env['two'], env['cfg'], env['ckpt'], '--aug-test', '--eval', 'mIoU',
        'mDice', '--out', '{out}/out.pkl', '--cfg-options', SCALE], 'aug')
    _assert_metrics_equal(dirs)
    assert _metrics(dirs['port'])[0] == 'eval_multi_scale'


def test_config_name_image_cache_and_checkpoint_meta(env, single, tmp_path,
                                                     monkeypatch):
    """A config named as ``<work_dirs>/<name>/<name>.py``, the test split
    behind ``data.img_cache='disk'`` (the cache written under the work
    dir) and the JAX CLI's metrics; without CLASSES in the checkpoint's
    meta the dataset's are taken."""
    name_dir = tmp_path / 'wds' / 'tiny'
    name_dir.mkdir(parents=True)
    shutil.copy(env['cfg'], name_dir / 'tiny.py')
    monkeypatch.chdir(tmp_path)
    port_cli.main([env['three'], 'tiny', env['ckpt'], '--work_dirs', 'wds',
                   '--eval', 'mIoU', 'mDice', '--device', 'cpu',
                   '--work-dir', 'named', '--cfg-options', SCALE,
                   'data.img_cache=disk', f'data.img_cache_dir={tmp_path}/c'])
    with open(tmp_path / 'named' / os.listdir(tmp_path / 'named')[0]) as f:
        got = json.load(f)['metric']
    assert got == _metrics(single['jax'])[1]['metric']
    # the 3 images: the labels come through the dataset's own loader
    assert len(os.listdir(tmp_path / 'c')) == 3
    model = build_segmentor(tiny_config(Config).model)
    from stc_unet_tpu_torch.engine import save_checkpoint
    bare = save_checkpoint(model, str(tmp_path / 'bare.pth'))
    results = port_cli.main([env['three'], env['cfg'], bare, '--device',
                             'cpu', '--work-dir', 'bare', '--cfg-options',
                             SCALE])
    assert len(results) == 3


def test_cli_refusals(monkeypatch):
    """A launcher needs the ranks of ``python -m torch.distributed.run``
    (no single-process fallback) and paints nothing; ``--gpu-collect``
    and ``--tmpdir`` are accepted, as in the JAX CLI; ``--show`` (a
    window) raises."""
    argv = ['x/images', STC_CONFIG, 'c.pth']
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        port_cli.main(argv + ['--launcher', 'pytorch', '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='paints nothing'):
        port_cli.main(argv + ['--launcher', 'pytorch', '--show-dir', 'd'])
    with pytest.raises(NotImplementedError, match='window'):
        port_cli.main(argv + ['--show'])
    import torch
    if not torch.cuda.is_available():
        for extra in ([], ['--gpu-collect', '--tmpdir', 't']):
            with pytest.raises(RuntimeError, match='CUDA is not available'):
                port_cli.main(argv + extra)


_BLOCKED = ('cv2', 'PIL', 'msgpack', 'jax', 'flax', 'stc_unet_tpu',
            'tensorboard', 'wandb')

_SCRIPT = '''
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import stc_unet_tpu_torch
modules = [m.name for m in pkgutil.walk_packages(
    stc_unet_tpu_torch.__path__, 'stc_unet_tpu_torch.')]
for name in modules:                # every module imports without them
    importlib.import_module(name)
assert len(modules) > 60, modules
from stc_unet_tpu_torch.tools.test import main
results = main([{data!r}, {cfg!r}, {ckpt!r}, '--eval', 'mDice',
                '--show-dir', 'vis', '--work-dir', 'wd', '--device', 'cpu',
                '--cfg-options', {scale!r}])
assert len(results) == 3
loaded = [n for n in sys.modules if n.split('.')[0] in {blocked!r}
          and sys.modules[n] is not None]
assert not loaded, loaded
print('tested without', {blocked!r})
'''


def test_cli_runs_without_cv2_pillow_msgpack_or_jax(env, single, tmp_path):
    script = _SCRIPT.format(blocked=_BLOCKED, repo=REPO, data=env['three'],
                            cfg=env['cfg'], ckpt=env['ckpt'], scale=SCALE)
    proc = subprocess.run([sys.executable, '-c', script],
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'tested without' in proc.stdout
    assert _metrics(tmp_path)[1]['metric']['mDice'] == \
        _metrics(single['port'])[1]['metric']['mDice']
    for name in os.listdir(tmp_path / 'vis'):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / 'vis' / name)),
            cv2.imread(str(single['jax'] / 'vis' / name)))


# -- show_result ----------------------------------------------------------------

@pytest.mark.parametrize('palette', [None, PALETTE])
def test_show_result_matches_jax(env, palette, tmp_path):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    seg = rng.randint(0, 3, (9, 11))
    jm = env['jm']
    tm = build_segmentor(tiny_config(Config).model)
    jm.PALETTE = tm.PALETTE = None
    want = jm.show_result(img, [seg], palette=palette, opacity=0.3)
    got = tm.show_result(img, [seg], palette=palette, opacity=0.3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    path = tmp_path / 'a' / 'b' / 'painted.png'
    assert tm.show_result(img, seg, palette=palette, out_file=str(path),
                          opacity=0.3) is None
    np.testing.assert_array_equal(cv2.imread(str(path)), want)
    png = tmp_path / 'img.png'
    cv2.imwrite(str(png), img)
    np.testing.assert_array_equal(
        tm.show_result(str(png), [seg], palette=palette, opacity=0.3), want)
    with pytest.raises(NotImplementedError, match='window'):
        tm.show_result(img, [seg], show=True)


# -- the decoded-image cache ----------------------------------------------------

@pytest.mark.parametrize('mode', ['ram', 'disk'])
def test_image_cache_serves_fresh_equal_arrays(mode, tmp_path):
    clear_ram_cache()
    paths = write_split(str(tmp_path / 's'), 2, 16, seed=6)
    ann = paths[0].replace('images', 'labels')
    kw = dict(cache=mode, cache_dir=str(tmp_path / 'cache'))
    loaders = {'img': (LoadImageFromFile(), LoadImageFromFile(**kw)),
               'ann': (LoadAnnotations(), LoadAnnotations(**kw))}

    def load(loader, which, path):
        if which == 'img':
            return loader(dict(img_info=dict(filename=path)))['img']
        return loader(dict(ann_info=dict(seg_map=path),
                           seg_fields=[]))['gt_semantic_seg']

    for which, path in (('img', paths[0]), ('ann', ann)):
        plain, cached = loaders[which]
        want = load(plain, which, path)
        first = load(cached, which, path)
        np.testing.assert_array_equal(first, want)
        first[...] = 7                          # a served array is private
        second = load(cached, which, path)
        np.testing.assert_array_equal(second, want)
        assert second.flags.writeable
        assert not np.shares_memory(first, second)
    # an edited file is decoded again
    edited = cv2.imread(paths[1])
    edited[0, 0] = (1, 2, 3)
    cv2.imwrite(paths[0], edited)
    st = os.stat(paths[0])
    os.utime(paths[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    np.testing.assert_array_equal(load(loaders['img'][1], 'img', paths[0]),
                                  edited)
    if mode == 'disk':
        assert len(os.listdir(tmp_path / 'cache')) == 2   # one entry a file
    assert 'cache=' + repr(mode) in repr(loaders['img'][1])


def test_inject_img_cache_matches_jax(tmp_path):
    for mode, cache_dir in (('ram', None), ('disk', '/c')):
        got = inject_img_cache(tiny_config(Config).to_dict()['data']['test'],
                               mode, cache_dir)
        want = jax_inject(tiny_config(JConfig).to_dict()['data']['test'],
                          mode, cache_dir)
        assert got == want and got['pipeline'][0]['cache'] == mode
    explicit = tiny_config(Config).to_dict()['data']['test']
    explicit['pipeline'][0]['cache'] = 'disk'
    assert inject_img_cache(explicit, 'ram')['pipeline'][0]['cache'] == 'disk'
    test = tiny_config(Config).data.test
    write_split(str(tmp_path), 1, 16)
    test.data_root = str(tmp_path)
    inject_img_cache(test, 'ram')
    assert build_dataset(test).pipeline.transforms[0].cache.mode == 'ram'


# -- the extra hooks ---------------------------------------------------------------

def _runner(tmp_path, meta=None):
    model = build_segmentor(tiny_config(Config).model)
    return EpochBasedRunner(model, build_optimizer(model, dict(
        type='Adam', lr=1e-5)), work_dir=str(tmp_path), max_epochs=1,
        meta=meta)


def test_wandb_hook_logs_through_wandb_and_warns_without_it(monkeypatch,
                                                            tmp_path):
    calls = []

    class Artifact:
        def __init__(self, name, type, metadata=None):
            calls.append(('artifact', name, type, metadata))

        def add_file(self, path):
            calls.append(('add_file', osp.basename(path)))

    fake = types.SimpleNamespace(
        init=lambda **kw: calls.append(('init', kw)),
        config=types.SimpleNamespace(
            update=lambda d: calls.append(('config', d))),
        log=lambda d, step: calls.append(('log', sorted(d), step)),
        run=types.SimpleNamespace(id='r1'), Artifact=Artifact,
        log_artifact=lambda a: calls.append(('log_artifact',)),
        finish=lambda: calls.append(('finish',)))
    monkeypatch.setitem(sys.modules, 'wandb', fake)
    runner = _runner(tmp_path, meta=dict(exp_name='e'))
    hook = MMSegWandbHook(init_kwargs=dict(project='p'), interval=2,
                          log_checkpoint=True, log_checkpoint_metadata=True)
    hook.before_run(runner)
    for it in range(4):
        runner.iter = it
        runner.log_buffer.update({'loss': float(it)})
        hook.after_train_iter(runner)
    (tmp_path / 'latest.pth').write_bytes(b'x')
    hook.after_train_epoch(runner)
    hook.after_run(runner)
    assert calls == [('init', {'project': 'p'}), ('config', {'exp_name': 'e'}),
                     ('log', ['loss'], 2), ('log', ['loss'], 4),
                     ('artifact', 'run_r1_model', 'model',
                      dict(epoch=1, iter=3)),
                     ('add_file', 'latest.pth'), ('log_artifact',),
                     ('finish',)]
    monkeypatch.setitem(sys.modules, 'wandb', None)
    hook, messages = MMSegWandbHook(), []
    monkeypatch.setattr(runner.logger, 'warning', messages.append)
    hook.before_run(runner)
    hook.after_train_iter(runner)
    hook.after_train_epoch(runner)
    hook.after_run(runner)
    assert hook.wandb is None and 'wandb' in messages[0]


def test_profiler_hook_traces_its_window(tmp_path):
    """Iterations 1 and 2 of 4 (CPU activity): the profiler starts before
    iteration 1 and stops after iteration 2, and the Chrome trace holds
    the ops of those steps only."""
    import torch
    runner = _runner(tmp_path)
    hook = TorchProfilerHook(start_iter=1, num_iters=2)
    runner.register_hook(hook)
    marks = []
    for it in range(4):
        runner.iter = it
        runner.call_hook('before_train_iter')
        marks.append(hook._prof is not None)
        with torch.profiler.record_function(f'step_{it}'):
            torch.ones(3).sum()
        runner.call_hook('after_train_iter')
    assert marks == [False, True, True, False] and hook._prof is None
    assert hook.trace_file == str(tmp_path / 'profile' /
                                  'trace_iter_1-2.json')
    with open(hook.trace_file) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'step_1', 'step_2'} <= names and not {'step_0',
                                                  'step_3'} & names


# -- the trained-accuracy protocol's fixture and config --------------------------

def test_parity_trained_fixture_and_config_match_the_jax_tool(tmp_path):
    """The port's ``build_learnable_kits`` writes the JAX tool's images and
    labels (the same draws; Pillow on the JAX side), and its config is the
    JAX tool's protocol."""
    from stc_unet_tpu_torch.tools import parity_trained
    jax_tool = runpy.run_path(osp.join(REPO, 'tools', 'parity_trained.py'))
    jax_tool['build_learnable_kits'](str(tmp_path / 'jax'), 2, 1, 32)
    parity_trained.build_learnable_kits(str(tmp_path / 'port'), 2, 1, 32)
    for split, n in (('train', 2), ('test', 1)):
        for d in ('images', 'labels'):
            for i in range(n):
                name = f'{split}/{d}/case_{i:05d}.png'
                np.testing.assert_array_equal(
                    np.array(Image.open(tmp_path / 'port' / name)),
                    np.array(Image.open(tmp_path / 'jax' / name)))
    path = str(tmp_path / 'cfg.py')
    parity_trained.write_cfg(path, 'ds', 15, 8, save_every=12,
                             save_optimizer=True, profile=(4, 2))
    cfg = Config.fromfile(path)
    assert (cfg.optimizer.type, cfg.optimizer.lr, cfg.data.samples_per_gpu,
            cfg.runner.max_epochs, cfg.bf16) == ('Adam', 3e-4, 8, 15, True)
    assert cfg.checkpoint_config.interval == 12 and \
        cfg.checkpoint_config.save_optimizer
    assert [h['type'] for h in cfg.custom_hooks] == [
        'ParityTrainedRecord', 'TorchProfilerHook']
