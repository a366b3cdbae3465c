"""The port's training path (``stc_unet_tpu_torch/engine``, ``apis/train.py``
and the train CLI) against the JAX package's, on the CPU.

``train_segmentor`` runs in both packages on a tiny STC-UNet (the widths
of ``tests/fixtures/torch_port.py``, ``dropout_ratio=0``, f32) from the
same weights (JAX variables drawn with numpy, carried by
``jax_to_torch_state``): the config's Adam (lr 1e-5) and poly lr by
epoch, the config's train pipeline at 32² crops on 4 pseudo-KiTS pairs, 2
epochs of 2 iterations at batch 2, ``workers_per_gpu=0``, validation
(mDice) after each epoch. The JAX run is built once for the module, as on
one device (``jax.local_device_count`` reads 1, so its batch is
``samples_per_gpu`` like the port's). Both take each sample's draws from
``np.random`` seeded with ``sample_seed(seed, epoch, rank, position)``:
the port through its loader, the JAX package through a wrapper of its
dataset defined here.

Tolerances are those of ``tests/test_torch_train_step.py``: the
per-iteration losses to rtol 1e-5; under Adam every parameter within
2·steps·lr of JAX's, the moves of coordinates whose first gradient is well
above its noise to lr/1000 after step 1 and 0.2·lr over each epoch, and
the BN running stats to rtol/atol 1e-3. The lr each step applied is held
to optax's schedule at rtol 1e-6. The validation mDice follows the
margin rule of ``tests/test_torch_eval.py``: pixels whose JAX class margin
lies within ``BAND`` of the margin's spread may take either label, so the two mDice may differ by those pixels over
the labelled ones (plus one step of ``evaluate``'s rounding, 1e-4).
``BAND`` is 1e-2 here, not 1e-3, because the two nets' weights differ by
Adam's noise-signed moves (up to ±lr a step on coordinates whose gradient
is noise); the logits' largest difference is checked to stay under it.
"""
import glob
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from stc_unet_tpu.apis import train_segmentor as jax_train
from stc_unet_tpu.datasets import build_dataset as jax_dataset
from stc_unet_tpu.engine import HOOKS as JHOOKS
from stc_unet_tpu.engine import Hook as JHook
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.utils import Config as JConfig
from stc_unet_tpu_torch.apis import init_segmentor, single_gpu_test
from stc_unet_tpu_torch.apis import train_segmentor
from stc_unet_tpu_torch.datasets import (DeviceBatchLoader,
                                         build_dataloader, build_dataset,
                                         sample_seed)
from stc_unet_tpu_torch.engine import (HOOKS, EpochBasedRunner, Hook,
                                       LogBuffer, TensorboardLoggerHook,
                                       find_latest_checkpoint,
                                       load_checkpoint, load_checkpoint_file,
                                       save_checkpoint)
from stc_unet_tpu_torch.core import build_optimizer
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures.torch_port import REPO, jax_variables, tiny_config, \
    write_split
from tests.test_torch_train_step import _assert_moves_close
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

EPOCHS, ITERS, BATCH, LR = 2, 2, 2, 1e-5
BAND = 1e-2


def _record(hook_base, name, snapshot):
    """A hook class that records, for each train iteration, its log
    values and ``snapshot(runner)`` (the parameters as named in the port,
    the lr the step applied), the start's snapshot, and each epoch's mDice
    (priority LOWEST: after the EvalHook)."""

    class Record(hook_base):
        runs = []

        def before_run(self, runner):
            self.runs.append(dict(losses=[], mdice=[], steps=[],
                                  start=snapshot(runner)))

        def after_train_iter(self, runner):
            self.runs[-1]['losses'].append(
                {k: float(v) for k, v in runner.outputs['log_vars'].items()})
            self.runs[-1]['steps'].append(snapshot(runner))

        def after_train_epoch(self, runner):
            self.runs[-1]['mdice'].append(
                runner.log_buffer.output.get('mDice'))

    Record.__name__ = name
    return Record


def _port_snapshot(runner):
    """The parameters, their gradients of the step just taken, and the
    lr the step applied to the optimizer."""
    named = list(runner.model.named_parameters())
    return dict(params={k: p.detach().clone() for k, p in named},
                grads={k: p.grad.clone() for k, p in named
                       if p.grad is not None},
                lr=runner.optimizer.param_groups[0]['lr'])


def _jax_snapshot(runner):
    """The parameters under the port's names, and the lr of optax's
    schedule at this step's count (the runner's ``iter``)."""
    return dict(params=jax_to_torch_state(jax.tree_util.tree_map(
                    np.asarray, {'params': runner.state.variables['params']})),
                lr=float(runner.lr_schedule(runner.iter)))


Record = HOOKS.register_module(
    module=_record(Hook, 'RecordTrainHook', _port_snapshot), force=True)
JRecord = JHOOKS.register_module(
    module=_record(JHook, 'RecordTrainHook', _jax_snapshot), force=True)


def train_config(config_cls, train_root, val_root, work_dir):
    """``my_config/STC-UNet.py`` at tiny widths with its own train
    pipeline at 32² crops (Resize to 40², RandomCrop 32² with
    cat_max_ratio 0.75, Pad to 32²), 2 epochs, checkpoint and mDice each
    epoch, a text log line each iteration."""
    cfg = tiny_config(config_cls)
    cfg.model.decode_head.dropout_ratio = 0.0
    pipe = cfg.data.train.pipeline
    pipe[2].img_scale = (40, 40)
    pipe[3].crop_size = (32, 32)
    pipe[7].size = (32, 32)
    cfg.data.update(samples_per_gpu=BATCH, workers_per_gpu=0)
    for split, root in (('train', train_root), ('val', val_root)):
        cfg.data[split].update(data_root=root, img_dir='test/images',
                               ann_dir='test/labels')
    cfg.runner.max_epochs = EPOCHS
    cfg.checkpoint_config.interval = 1
    cfg.log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
    cfg.evaluation = dict(interval=1, metric='mDice')
    cfg.custom_hooks = [dict(type='RecordTrainHook', priority='LOWEST')]
    cfg.work_dir = work_dir
    cfg.seed = 0
    return cfg


class SeededJaxDataset:
    """The JAX train dataset with ``np.random`` seeded before each sample
    as the port's loader seeds its generator: the JAX loader with no
    workers loads the samples in order, so the n-th call is position
    ``n mod per_epoch`` of epoch ``n // per_epoch``."""

    def __init__(self, dataset, seed, per_epoch):
        self.dataset, self.seed, self.per_epoch = dataset, seed, per_epoch
        self.calls = 0
        self.CLASSES, self.PALETTE = dataset.CLASSES, dataset.PALETTE

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        epoch, position = divmod(self.calls, self.per_epoch)
        self.calls += 1
        np.random.seed(sample_seed(self.seed, epoch, 0, position))
        return self.dataset[idx]


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp('train')
    write_split(str(base / 'train'), 4, 32, seed=1)
    write_split(str(base / 'val'), 2, 32, seed=2)
    return str(base / 'train'), str(base / 'val'), base


@pytest.fixture(scope='module')
def trained(roots):
    """Both packages' ``train_segmentor`` runs from the same weights:
    (JAX runner, its record, port runner, its record, work dirs)."""
    train_root, val_root, base = roots
    jcfg = train_config(JConfig, train_root, val_root, str(base / 'jax'))
    jm = jax_build(jcfg.model)
    jm.variables = jax_variables(jm)
    tcfg = train_config(Config, train_root, val_root, str(base / 'port'))
    tm = build_segmentor(tcfg.model)
    tm.load_state_dict(jax_to_torch_state(jm.variables), strict=True)
    jds = jax_dataset(jcfg.data.train)
    tds = build_dataset(tcfg.data.train)
    for m, ds in ((jm, jds), (tm, tds)):
        m.CLASSES, m.PALETTE = ds.CLASSES, ds.PALETTE
    count = jax.local_device_count
    jax.local_device_count = lambda *a, **k: 1
    try:
        jrunner = jax_train(jm, SeededJaxDataset(jds, 0, ITERS * BATCH),
                            jcfg, validate=True)
    finally:
        jax.local_device_count = count
    trunner = train_segmentor(tm, tds, tcfg, validate=True, device='cpu')
    return jrunner, JRecord.runs[-1], trunner, Record.runs[-1], base


def test_train_segmentor_losses_params_and_stats_match_jax(trained):
    jrunner, jrec, trunner, trec, _ = trained
    assert len(trec['losses']) == len(jrec['losses']) == EPOCHS * ITERS
    for i, (got, want) in enumerate(zip(trec['losses'], jrec['losses'])):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f'iteration {i} {k}')
    assert trunner.iter == EPOCHS * ITERS and trunner.epoch == EPOCHS
    ref = jax_to_torch_state(jax.tree_util.tree_map(
        np.asarray, jrunner.state.variables))
    sd = trunner.model.state_dict()
    for k, want in ref.items():
        if k.endswith('num_batches_tracked'):
            assert int(sd[k]) == EPOCHS * ITERS, k
        elif k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=0,
                                       atol=2 * EPOCHS * ITERS * LR,
                                       err_msg=k)


def test_train_segmentor_moves_and_lr_match_jax(trained):
    """The lr each step applied, and the parameters' moves where the first
    gradient is well above its noise, against JAX's. The lr is held to
    optax's schedule at each step's count (poly by epoch: the config's lr
    in epoch 1, 0.536 of it in epoch 2), read from the optimizer after
    the step, not from the runner's ``current_lr``. The moves are held as
    ``tests/test_torch_train_step.py`` holds them: after step 1 to lr/1000
    on coordinates whose first gradient is at least 1e-3 of the largest,
    and each epoch's moves to 0.2·lr on those at least 1e-2 of it (seen:
    5e-10 after step 1, 7e-9 and 1.2e-7 over epochs 1 and 2). A state left
    as it started fails the first: step 1 moves each such coordinate by lr
    on JAX's side (1.0e-5 off, seen). A wrong lr for an epoch fails the
    second: epoch 2 at the config's lr moves them up to 0.84·lr further
    than JAX's (8.4e-6 off, seen)."""
    _, jrec, _, trec, _ = trained
    for k, p in trec['start']['params'].items():
        assert torch.equal(p, jrec['start']['params'][k]), k
    lrs = [s['lr'] for s in trec['steps']]
    np.testing.assert_allclose(lrs, [s['lr'] for s in jrec['steps']],
                               rtol=1e-6)
    assert lrs[0] == lrs[1] == LR and lrs[2] == lrs[3] < 0.6 * LR
    points = [trec['start']] + trec['steps']
    jpoints = [jrec['start']] + jrec['steps']

    def moves(a, b):
        return {k: (points[b]['params'][k] - points[a]['params'][k],
                    jpoints[b]['params'][k] - jpoints[a]['params'][k])
                for k in points[0]['params']}

    g1 = trec['steps'][0]['grads']
    assert sorted(g1) == sorted(points[0]['params'])
    scale = max(g.abs().max().item() for g in g1.values())
    _assert_moves_close(moves(0, 1), g1, 1e-3 * scale, atol=1e-3 * LR)
    for a, b in ((0, ITERS), (ITERS, 2 * ITERS)):
        _assert_moves_close(moves(a, b), g1, 1e-2 * scale, atol=0.2 * LR)


def _test_split(root):
    test = tiny_config(Config).data.test
    test.update(data_root=root, test_mode=True)
    return build_dataset(test)


def test_train_segmentor_mdice_matches_jax(trained, roots):
    jrunner, jrec, trunner, trec, _ = trained
    assert len(trec['mdice']) == len(jrec['mdice']) == EPOCHS
    _, val_root, _ = roots
    val = _test_split(val_root)
    imgs = np.stack([val[i]['img'][0] for i in range(len(val))])
    jlogits = np.asarray(jrunner.model.encode_decode(imgs))
    tlogits = trunner.model.encode_decode(imgs).numpy()
    margin = jlogits[..., 1] - jlogits[..., 0]
    spread = margin.std()
    tmargin = tlogits[..., 1] - tlogits[..., 0]
    assert np.abs(tmargin - margin).max() < BAND * spread
    excluded = np.abs(margin) <= BAND * spread
    labelled = sum(int((m != 255).sum()) for m in val.get_gt_seg_maps())
    limit = excluded.sum() / labelled + 1e-4
    got, want = trec['mdice'][-1], jrec['mdice'][-1]
    assert abs(got - want) <= limit, (got, want, limit)


def test_log_json_lines_carry_jax_keys(trained):
    _, _, _, _, base = trained
    lines = {}
    for side in ('jax', 'port'):
        files = glob.glob(str(base / side / '*.log.json'))
        assert len(files) == 1
        with open(files[0]) as f:
            lines[side] = [json.loads(line) for line in f]
    assert len(lines['port']) == len(lines['jax']) == EPOCHS * ITERS
    for got, want in zip(lines['port'], lines['jax']):
        assert list(got) == list(want)
        assert [got[k] for k in ('mode', 'epoch', 'iter', 'lr')] == \
            [want[k] for k in ('mode', 'epoch', 'iter', 'lr')]


def test_checkpoints_written_and_reloaded(trained):
    """epoch_1.pth, epoch_2.pth and latest.pth (a link to the last) in
    the fork's layout; the last reloads into a fresh model bit for bit."""
    _, _, trunner, _, base = trained
    work = str(base / 'port')
    assert osp.realpath(find_latest_checkpoint(work)) == \
        osp.realpath(osp.join(work, f'epoch_{EPOCHS}.pth'))
    ckpt = torch.load(osp.join(work, 'latest.pth'), weights_only=False)
    assert set(ckpt) == {'meta', 'state_dict'}     # save_optimizer=False
    assert ckpt['meta']['epoch'] == EPOCHS
    assert ckpt['meta']['iter'] == EPOCHS * ITERS
    assert list(ckpt['meta']['CLASSES']) == ['background', 'target']
    fresh = build_segmentor(tiny_config(Config).model)
    load_checkpoint(fresh, osp.join(work, 'latest.pth'))
    for k, v in trunner.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert tuple(fresh.CLASSES) == ('background', 'target')


# -- resuming, the log buffer, the hooks -------------------------------------

def _port_run(roots, work, epochs, resume_from=None, save_optimizer=True,
              max_keep=-1):
    train_root, val_root, _ = roots
    cfg = train_config(Config, train_root, val_root, work)
    cfg.custom_hooks = []
    cfg.runner.max_epochs = epochs
    cfg.checkpoint_config.update(save_optimizer=save_optimizer,
                                 max_keep_ckpts=max_keep)
    cfg.resume_from = resume_from
    model = build_segmentor(cfg.model).init_weights(seed=3)
    return train_segmentor(model, build_dataset(cfg.data.train), cfg,
                           device='cpu')


def test_resume_continues_as_an_unbroken_run(roots, tmp_path):
    """Two epochs, or one epoch and a resume from its checkpoint (weights,
    Adam's state, the counts): the same weights bit for bit."""
    whole = _port_run(roots, str(tmp_path / 'whole'), 2)
    _port_run(roots, str(tmp_path / 'half'), 1)
    resumed = _port_run(roots, str(tmp_path / 'resumed'), 2,
                        resume_from=str(tmp_path / 'half' / 'epoch_1.pth'))
    assert resumed.epoch == whole.epoch == 2
    assert resumed.iter == whole.iter == 2 * ITERS
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    ckpt = torch.load(str(tmp_path / 'half' / 'epoch_1.pth'),
                      weights_only=False)
    assert set(ckpt) == {'meta', 'state_dict', 'optimizer'}


def test_max_keep_ckpts_and_auto_resume(roots, tmp_path):
    work = str(tmp_path / 'keep')
    _port_run(roots, work, 3, max_keep=2)
    assert sorted(f for f in os.listdir(work) if f.endswith('.pth')) == \
        ['epoch_2.pth', 'epoch_3.pth', 'latest.pth']
    train_root, val_root, _ = roots
    cfg = train_config(Config, train_root, val_root, work)
    cfg.custom_hooks = []
    cfg.runner.max_epochs = 3
    cfg.auto_resume = True
    model = build_segmentor(cfg.model)
    runner = train_segmentor(model, build_dataset(cfg.data.train), cfg,
                             device='cpu')
    assert runner.epoch == 3 and runner.iter == 3 * ITERS   # nothing left


def test_iter_based_runner_trains_saves_and_evaluates_by_iteration(
        roots, tmp_path):
    """3 iterations over 2-iteration epochs (the loader cycles into a new
    permutation), a checkpoint every 2 iterations and at the last, mDice
    every 2 iterations; the lr follows the poly schedule by epoch."""
    train_root, val_root, _ = roots
    work = str(tmp_path / 'iters')
    cfg = train_config(Config, train_root, val_root, work)
    cfg.runner = dict(type='IterBasedRunner', max_iters=3)
    cfg.checkpoint_config = dict(by_epoch=False, interval=2)
    cfg.evaluation = dict(interval=2, metric='mDice', save_best='mDice')
    model = build_segmentor(cfg.model).init_weights(seed=2)
    runner = train_segmentor(model, build_dataset(cfg.data.train), cfg,
                             validate=True, device='cpu')
    run = Record.runs[-1]
    assert runner.iter == 3 and len(run['losses']) == 3
    assert sorted(f for f in os.listdir(work) if f.endswith('.pth')) == \
        ['best_mDice_iter_2.pth', 'iter_2.pth', 'iter_3.pth', 'latest.pth']
    assert torch.load(osp.join(work, 'iter_2.pth'),
                      weights_only=False)['meta']['iter'] == 2
    with open(glob.glob(osp.join(work, '*.log.json'))[0]) as f:
        lines = [json.loads(line) for line in f]
    evaluated = [line for line in lines if 'mDice' in line]
    assert [line['iter'] for line in evaluated] == [2]
    assert evaluated[0]['eval_iter_num'] == 2
    assert runner.current_lr() < LR


def test_set_random_seed_seeds_and_sets_the_cudnn_flags():
    from stc_unet_tpu_torch.apis import init_random_seed, set_random_seed
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = True
        set_random_seed(4, deterministic=True)
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        a = (np.random.rand(), torch.rand(1).item())
        set_random_seed(4)
        assert (np.random.rand(), torch.rand(1).item()) == a
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    assert init_random_seed(9) == 9
    assert 0 <= init_random_seed() < 2 ** 31


def test_log_buffer_reads_device_values_once_and_averages_by_count():
    buf = LogBuffer()
    buf.update({'loss': torch.tensor(1.0), 'time': 0.5}, count=2)
    buf.update({'loss': torch.tensor(4.0), 'time': 1.5}, count=1)
    buf.average()
    assert buf.ready and buf.output == {'loss': 2.0, 'time': 5 / 6}
    buf.average(1)
    assert buf.output == {'loss': 4.0, 'time': 1.5}
    buf.clear()
    assert not buf.ready and not buf.val_history


def test_tensorboard_hook_warns_and_does_nothing_without_tensorboard(
        monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    model = build_segmentor(tiny_config(Config).model)
    runner = EpochBasedRunner(model, build_optimizer(model, dict(
        type='Adam', lr=LR)), work_dir=str(tmp_path), max_epochs=1)
    hook = TensorboardLoggerHook(interval=1)
    messages = []
    monkeypatch.setattr(runner.logger, 'warning', messages.append)
    hook.before_run(runner)
    hook.after_train_iter(runner)
    hook.after_run(runner)
    assert hook.writer is None and 'tensorboard' in messages[0]


def test_what_is_not_ported_raises(roots, tmp_path):
    train_root, val_root, _ = roots
    cfg = train_config(Config, train_root, val_root, str(tmp_path))
    model = build_segmentor(cfg.model)
    ds = build_dataset(cfg.data.train)
    # data parallelism is ported (item 14), one process a card: without
    # the ranks' process group, or with two cards in one process, it
    # raises (remat is ported: cfg.remat trains through the CLI in
    # test_torch_psp_aspp.py)
    cases = [(dict(distributed=True), {}, RuntimeError, 'init_dist'),
             ({}, dict(gpu_ids=[0, 1]), NotImplementedError,
              'torch.distributed.run')]
    for kw, extra, error, match in cases:
        with pytest.raises(error, match=match):
            train_segmentor(model, ds, Config(dict(cfg.to_dict(), **extra)),
                            device='cpu', **kw)
    # data.device_pipeline is ported (item 4): the loader is wrapped
    dp = Config(cfg.to_dict())
    dp.data.device_pipeline = True
    dp.runner.max_epochs = 1
    dp.custom_hooks = []
    dp.work_dir = str(tmp_path / 'device_pipeline')
    runner = train_segmentor(model, build_dataset(dp.data.train), dp,
                             device='cpu')
    assert isinstance(runner.data_loader, DeviceBatchLoader)
    assert runner.iter == len(runner.data_loader)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            train_segmentor(model, ds, cfg)
    # a JAX .ckpt resumes (Item 13b, ported): the fixture's weights, its
    # Adam state and counts (epoch 1 of 1: nothing left to train)
    ckpt = osp.join(REPO, 'tests', 'fixtures', 'stc_unet_tiny_adam.ckpt')
    resume = Config(cfg.to_dict())
    widths = load_checkpoint_file(ckpt)['meta']['widths']
    resume.model.backbone.channel_list = widths['channel_list']
    resume.model.decode_head.update(
        channels=widths['channels'],
        decoder_channel=widths['decoder_channel'])
    resume.runner.max_epochs = 1
    resume.resume_from = ckpt
    runner = train_segmentor(build_segmentor(resume.model), ds, resume,
                             device='cpu')
    assert (runner.epoch, runner.iter) == (1, 2)
    state = runner.optimizer.state[next(runner.model.parameters())]
    assert float(state['step']) == 2 and bool(state['exp_avg'].any())
    # DistEvalHook is ported (item 14): it evaluates through
    # multi_gpu_test, and takes the reference's arguments
    from stc_unet_tpu_torch.apis import multi_gpu_test
    from stc_unet_tpu_torch.engine import DistEvalHook, EvalHook
    loader = build_dataloader(ds, 1, 0, shuffle=False)
    hook = DistEvalHook(loader, broadcast_bn_buffer=True, gpu_collect=True)
    assert hook.test_fn is multi_gpu_test
    assert EvalHook(loader).test_fn is single_gpu_test


# -- the CLI, where the card's machine lacks cv2, Pillow, msgpack and jax ----

_BLOCKED = ('cv2', 'PIL', 'msgpack', 'jax', 'flax', 'stc_unet_tpu',
            'tensorboard')

_SCRIPT = '''
import sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
from stc_unet_tpu_torch.tools.train import main
argv = [{config!r}, '--work-dir', 'wd', '--seed', '5', '--cfg-options',
        'model.backbone.channel_list=[8,16,16,16]',
        'model.decode_head.channels=8',
        'model.decode_head.decoder_channel=[32,32,32,32,8]',
        'data.train.data_root={train}', 'data.val.data_root={val}',
        'data.train.img_dir=test/images', 'data.train.ann_dir=test/labels',
        'data.train.pipeline.2.img_scale=(40,40)',
        'data.train.pipeline.3.crop_size=(32,32)',
        'data.train.pipeline.7.size=(32,32)',
        'data.val.pipeline.1.img_scale=(32,32)',
        'data.samples_per_gpu=2', 'data.workers_per_gpu=2',
        'runner.max_epochs=1', 'checkpoint_config.interval=1',
        'log_config.interval=1']
try:
    main(argv)
except RuntimeError as e:
    assert 'CUDA is not available' in str(e), e
    print('no CUDA: refused')
runner = main(argv + ['--device', 'cpu'])
assert runner.epoch == 1
loaded = [n for n in sys.modules if n.split('.')[0] in {blocked!r}
          and sys.modules[n] is not None]
assert not loaded, loaded
print('trained without', {blocked!r})
'''


def test_train_cli_runs_without_cv2_pillow_msgpack_or_jax(roots, tmp_path):
    train_root, val_root, _ = roots
    script = _SCRIPT.format(blocked=_BLOCKED, repo=REPO,
                            config=osp.join(REPO, 'my_config', 'STC-UNet.py'),
                            train=train_root, val=val_root)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', textwrap.dedent(script)],
                          stdin=subprocess.DEVNULL, capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'trained without' in proc.stdout
    if not torch.cuda.is_available():
        assert 'no CUDA: refused' in proc.stdout
    work = tmp_path / 'wd'
    names = os.listdir(work)
    assert {'epoch_1.pth', 'latest.pth', 'STC-UNet.py'} <= set(names)
    assert any(n.endswith('.log.json') for n in names)
    assert any(n.endswith('.log') for n in names)
    model = init_segmentor(str(work / 'STC-UNet.py'),
                           str(work / 'latest.pth'), device='cpu')
    loader = build_dataloader(_test_split(val_root), 1, 0, shuffle=False)
    assert len(single_gpu_test(model, loader, pre_eval=True)) == 2


def test_cli_refuses_launchers_and_many_gpus(monkeypatch):
    """One process drives one card: more than one GPU in a process raises
    and says how to launch; ``--launcher pytorch`` needs the ranks of
    ``python -m torch.distributed.run`` (no single-process fallback);
    other launchers are not ported. The launcher itself runs in
    ``test_torch_data_parallel.py``."""
    from stc_unet_tpu_torch.tools.train import main
    config = osp.join(REPO, 'my_config', 'STC-UNet.py')
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    for extra in (['--gpus', '2'], ['--gpu-ids', '0', '1']):
        with pytest.raises(NotImplementedError,
                           match='torch.distributed.run'):
            main([config] + extra)
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        main([config, '--launcher', 'pytorch', '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='slurm'):
        main([config, '--launcher', 'slurm', '--device', 'cpu'])


def test_save_checkpoint_keeps_meta_and_optimizer(tmp_path):
    model = build_segmentor(tiny_config(Config).model).init_weights(seed=1)
    model.CLASSES, model.PALETTE = ('a', 'b'), [[0, 0, 0], [1, 1, 1]]
    opt = build_optimizer(model, dict(type='Adam', lr=LR))
    path = save_checkpoint(model, str(tmp_path / 'c.pth'), opt,
                           meta=dict(epoch=3))
    ckpt = torch.load(path, weights_only=False)
    assert ckpt['meta']['epoch'] == 3 and ckpt['meta']['CLASSES'] == \
        ('a', 'b') and 'stc_unet_tpu_torch_version' in ckpt['meta']
    assert ckpt['optimizer'] == opt.state_dict()
    assert not osp.exists(path + '.tmp')
    assert find_latest_checkpoint(str(tmp_path)) == path
    assert find_latest_checkpoint(str(tmp_path / 'none')) is None


_TRAINING_MODULES = (
    'utils/image.py', 'datasets/builder.py', 'datasets/custom.py',
    'datasets/pipelines/transforms.py', 'datasets/pipelines/formatting.py',
    'datasets/samplers/__init__.py',
    'datasets/samplers/distributed_sampler.py', 'engine/__init__.py',
    'engine/checkpoint.py', 'engine/eval_hooks.py', 'engine/hooks.py',
    'engine/runner.py', 'engine/train_state.py', 'apis/__init__.py',
    'apis/train.py', 'tools/train.py')


def test_training_modules_import_no_cv2_pillow_msgpack_or_jax():
    """The training path's modules (and ``chip_smoke.py``) import none of
    what the card's machine lacks: cv2, Pillow, msgpack, jax and its
    libraries, or the JAX package. The other guards walk the whole
    package; this one names the training path's files, so that one
    moved or renamed away is noticed."""
    import ast
    files = [osp.join(REPO, 'stc_unet_tpu_torch', m)
             for m in _TRAINING_MODULES] + [osp.join(REPO, 'chip_smoke.py')]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and
                     node.level == 0 else [])
            bad += [(path, n) for n in names if n.split('.')[0] in (
                'cv2', 'PIL', 'msgpack', 'jax', 'jaxlib', 'flax', 'optax',
                'stc_unet_tpu', 'mmseg', '__graft_entry__')]
    assert not bad, bad
