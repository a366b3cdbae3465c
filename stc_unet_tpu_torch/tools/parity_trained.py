"""The trained-accuracy protocol of ``tools/parity_trained.py``, the port's
half: full-width STC-UNet trained to a working model through the port's
train CLI and evaluated through its test CLI.

    python -m stc_unet_tpu_torch.tools.parity_trained [--epochs 15]
        [--batch 8] [--size 512] [--train-imgs 32] [--test-imgs 8]
        [--work-dir D] [--device cuda|cpu] [--out F.json]
        [--pipeline both|host|device] [--resume-span K]
        [--profile START NUM]

It writes the JAX tool's learnable pseudo-KiTS fixture (a bright
elliptical blob on a dark noisy background, the label the blob; seed 0,
the same draws) with the port's PNG writer and trains
``my_config/STC-UNet.py`` at the JAX protocol (Adam lr 3e-4, batch 8,
``bf16 = True``, 2 loader threads, no validation) with
``python -m stc_unet_tpu_torch.tools.train`` twice, as the JAX tool
does: with the host pipeline, then with ``data.device_pipeline=True``
(the augmentation on the device, ``datasets/device_pipeline.py``);
``--pipeline host`` or ``device`` runs one of them. It evaluates each
run's checkpoint with ``python -m stc_unet_tpu_torch.tools.test --eval
mIoU mDice``. It prints one JSON record: the last run's mIoU and mDice
(the device run's, the one the JAX tool evaluates) beside the JAX
package's from ``PARITY_KITS_TRAINED.json``; for each run (``runs``) its
mIoU and mDice, its epochs' seconds and images/s (the card synced at
each epoch's start and end), its mean ``data_time`` over the later
iterations (the JAX tool's ``mean_data_time``) and over the epochs'
first batches and the rest, its loader's type and where its batches
were, the test CLI's seconds and slices/s, and on the card the step
alone on its last batch and the host's share of the epochs; the last
run's losses.

``--resume-span K`` also saves ``epoch_{E-K}.pth`` of the last run with
its optimizer, resumes another run from it to epoch E, and records how
far that run's first step's losses and its final weights are from the
unbroken run's. ``--profile START NUM`` traces NUM train steps of the
last run from step START with the port's ``TorchProfilerHook`` (a
Chrome trace under its work dir's ``profile``).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from stc_unet_tpu_torch.engine import HOOKS, Hook
from stc_unet_tpu_torch.utils import png

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
CONFIG = osp.join(REPO, 'my_config', 'STC-UNet.py')
JAX_RECORD = osp.join(REPO, 'PARITY_KITS_TRAINED.json')


def build_learnable_kits(root: str, n_train: int, n_test: int, size: int):
    """The JAX tool's fixture (``tools/parity_trained.py:35-58``) with the
    same draws, written by the port's PNG writer: RGB images and 0/1
    gray labels in ``root``/{train,test}/{images,labels}. The draws run
    in order here and the files are written by 8 threads (the writer's
    numpy and zlib leave the interpreter lock)."""
    rng = np.random.RandomState(0)
    with ThreadPoolExecutor(8) as pool:
        writes = []
        for split, n in (('train', n_train), ('test', n_test)):
            os.makedirs(f'{root}/{split}/images', exist_ok=True)
            os.makedirs(f'{root}/{split}/labels', exist_ok=True)
            for i in range(n):
                yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
                cy, cx = rng.randint(size // 4, 3 * size // 4, 2)
                ry = rng.randint(size // 8, size // 4)
                rx = rng.randint(size // 8, size // 4)
                blob = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1.0
                img = rng.rand(size, size).astype(np.float32) * 0.35
                img[blob] += 0.45 + 0.1 * rng.rand()
                img = np.clip(img + rng.randn(size, size) * 0.05, 0, 1)
                rgb = (np.stack([img] * 3, -1) * 255).astype(np.uint8)
                writes += [
                    pool.submit(png.write,
                                f'{root}/{split}/images/case_{i:05d}.png',
                                rgb),
                    pool.submit(png.write,
                                f'{root}/{split}/labels/case_{i:05d}.png',
                                blob.astype(np.uint8))]
        for w in writes:
            w.result()


def write_cfg(path: str, data_root: str, epochs: int, batch: int,
              save_every: int, save_optimizer: bool, profile=None,
              device_pipeline: bool = False):
    """The JAX tool's config (``data.device_pipeline`` as given); a
    checkpoint every ``save_every`` epochs and at the last; the recording
    hook, and a ``TorchProfilerHook`` when ``profile`` is (start, num)."""
    hooks = [dict(type='ParityTrainedRecord', priority='HIGHEST')]
    if profile:
        hooks.append(dict(type='TorchProfilerHook', start_iter=profile[0],
                          num_iters=profile[1]))
    cfg = f'''
_base_ = [{CONFIG!r}]
data = dict(samples_per_gpu={batch}, workers_per_gpu=2,
            device_pipeline={device_pipeline},
            train=dict(data_root={data_root!r}),
            val=dict(data_root={data_root!r}),
            test=dict(data_root={data_root!r}))
optimizer = dict(type='Adam', lr=3e-4, betas=(0.9, 0.999))
runner = dict(type='EpochBasedRunner', max_epochs={epochs})
checkpoint_config = dict(by_epoch=True, interval={save_every},
                         save_optimizer={save_optimizer})
evaluation = dict(interval={epochs + 1}, metric=['mDice'])
log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
custom_hooks = {hooks!r}
bf16 = True
'''
    with open(path, 'w') as f:
        f.write(cfg)


@HOOKS.register_module()
class ParityTrainedRecord(Hook):
    """Each train epoch's seconds (the card synced at its start and end),
    each step's log values (left on the device until the run ends) and
    ``data_time`` with its place in the epoch, and the last batch on the
    device; the records of every run of the process are kept in
    ``runs``."""

    runs = []

    def before_run(self, runner):
        self.runs.append(dict(epoch_s=[], logs=[], data_time=[],
                              first_iter=runner.iter))

    def _sync(self, runner):
        if runner.device.type == 'cuda':
            torch.cuda.synchronize(runner.device)

    def before_train_epoch(self, runner):
        self._sync(runner)
        self._t0 = time.perf_counter()

    def after_train_iter(self, runner):
        self.runs[-1]['logs'].append(runner.outputs['log_vars'])
        self.runs[-1]['data_time'].append(
            (runner.inner_iter,
             runner.log_buffer.val_history['data_time'][-1]))
        self.runs[-1]['batch'] = (runner.data_batch['img'],
                                  runner.data_batch['gt_semantic_seg'])

    def after_train_epoch(self, runner):
        self._sync(runner)
        self.runs[-1]['epoch_s'].append(time.perf_counter() - self._t0)

    def after_run(self, runner):
        logs = self.runs[-1]['logs']
        self.runs[-1]['losses'] = {
            k: [float(lv[k]) for lv in logs] for k in (logs[0] if logs
                                                       else ())}


def _train(argv, device):
    from stc_unet_tpu_torch.tools import train as train_cli
    t0 = time.perf_counter()
    runner = train_cli.main(argv + ['--device', device])
    return runner, ParityTrainedRecord.runs[-1], time.perf_counter() - t0


def mean_log_value(log_dir: str, key: str) -> float:
    """The mean of ``key`` (``'data_time'``, ``'time'``) in the newest
    ``.log.json`` in ``log_dir`` over the later train iterations, from the
    larger of 2 and a quarter of them on (the JAX tool's
    ``mean_data_time``)."""
    logs = sorted(f for f in os.listdir(log_dir) if f.endswith('.log.json'))
    if not logs:
        raise RuntimeError(f'no .log.json in {log_dir}')
    values = []
    with open(osp.join(log_dir, logs[-1])) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get('mode') == 'train' and key in rec:
                values.append(float(rec[key]))
    tail = values[max(2, len(values) // 4):]
    if not tail:
        raise RuntimeError(f'no train {key} records in {logs[-1]} past '
                           f'the first {max(2, len(values) // 4)}')
    return sum(tail) / len(tail)


def _mean(values):
    return sum(values) / len(values) if values else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--train-imgs', type=int, default=32)
    ap.add_argument('--test-imgs', type=int, default=8)
    ap.add_argument('--epochs', type=int, default=15)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--work-dir', default=osp.join('work_dirs',
                                                   'parity_trained'))
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--out', help='write the record here too')
    ap.add_argument('--pipeline', default='both',
                    choices=['both', 'host', 'device'],
                    help='train with the host pipeline, the device one, or '
                         'both (host first)')
    ap.add_argument('--resume-span', type=int, default=0,
                    help='resume a second run for the last K epochs')
    ap.add_argument('--profile', type=int, nargs=2, metavar=('START', 'NUM'),
                    help='trace NUM train steps from step START')
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol; returns the record (and prints it)."""
    args = parse_args(argv)
    from stc_unet_tpu_torch.tools import test as test_cli
    epochs, span = args.epochs, args.resume_span
    if not 0 <= span < epochs:
        raise ValueError(f'--resume-span {span}: 0 to {epochs - 1}')
    modes = ['host', 'device'] if args.pipeline == 'both' else \
        [args.pipeline]
    work = osp.abspath(args.work_dir)
    data_root = osp.join(work, 'ds')
    t0 = time.perf_counter()
    build_learnable_kits(data_root, args.train_imgs, args.test_imgs,
                         args.size)
    record = dict(size=args.size, epochs=epochs, batch=args.batch,
                  train_imgs=args.train_imgs, test_imgs=args.test_imgs,
                  device=args.device, pipelines=modes,
                  fixture_s=time.perf_counter() - t0, runs={})
    for mode in modes:
        last = mode == modes[-1]
        cfg_path = osp.join(work, f'cfg_{mode}.py')
        write_cfg(cfg_path, data_root, epochs, args.batch,
                  save_every=epochs - span if span and last else epochs,
                  save_optimizer=bool(span) and last,
                  profile=args.profile if last else None,
                  device_pipeline=mode == 'device')
        wd = osp.join(work, f'wd_{mode}')
        runner, run, train_s = _train(
            [cfg_path, '--work-dir', wd, '--no-validate', '--seed', '0'],
            args.device)
        steps = len(run['logs'])
        record['runs'][mode] = dict(
            train_s=train_s, steps=steps, epoch_s=run['epoch_s'],
            img_per_s=steps * args.batch / sum(run['epoch_s']),
            mean_data_time_s=mean_log_value(wd, 'data_time'),
            data_time_after_first_mean_s=_mean(
                [t for i, t in run['data_time'] if i]),
            data_time_first_mean_s=_mean(
                [t for i, t in run['data_time'] if not i]),
            loader=type(runner.data_loader).__name__,
            batch_device=str(run['batch'][0].device),
            checkpoint=osp.join(wd, 'latest.pth'),
            **evaluate_checkpoint(test_cli, data_root, cfg_path,
                                  osp.join(wd, 'latest.pth'),
                                  osp.join(work, f'metrics_{mode}'),
                                  args.test_imgs, args.device))
        if not last:
            if runner.device.type == 'cuda':
                record['runs'][mode].update(_step_alone(runner, run))
            del runner
            continue
        record.update(record['runs'][mode], losses=run['losses'])
        for hook in runner.hooks:
            if type(hook).__name__ == 'TorchProfilerHook':
                record['profile_trace'] = hook.trace_file
    if osp.isfile(JAX_RECORD):
        with open(JAX_RECORD) as f:
            jax_record = json.load(f)
        record['jax'] = dict(jax_record['jax'], epochs=jax_record['epochs'],
                             batch=jax_record['batch'],
                             source='PARITY_KITS_TRAINED.json')
    if span:
        record['resume'] = _resume_check(runner, run, cfg_path, wd, work,
                                         epochs - span, args)
    if runner.device.type == 'cuda':
        alone = _step_alone(runner, run)
        record.update(alone)
        record['runs'][modes[-1]].update(alone)
    del runner
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(record, f, indent=2)
    return record


def evaluate_checkpoint(test_cli, data_root, cfg_path, checkpoint,
                        json_dir, test_imgs, device):
    """``checkpoint`` through the test CLI on the test split of
    ``test_imgs`` images: the port's mIoU and mDice, the CLI's seconds and
    slices/s."""
    t0 = time.perf_counter()
    test_cli.main([f'{data_root}/test/images', cfg_path, checkpoint,
                   '--eval', 'mIoU', 'mDice', '--work-dir', json_dir,
                   '--device', device])
    test_s = time.perf_counter() - t0
    newest = sorted(f for f in os.listdir(json_dir) if f.endswith('.json'))
    with open(osp.join(json_dir, newest[-1])) as f:
        metric = json.load(f)['metric']
    return dict(port={k: float(metric[k]) for k in ('mIoU', 'mDice')},
                test_s=test_s, test_slices_per_s=test_imgs / test_s)


def _step_alone(runner, run, iters=10):
    """The train step alone on the run's last batch (one CUDA event pair
    over ``iters`` steps after 2), and the host's share of the epochs:
    (epochs' seconds - steps · step) / epochs' seconds. It trains the
    model further, so it comes after every use of the run's weights."""
    img, gt = run['batch']
    generator = torch.Generator(device=runner.device).manual_seed(0)
    for _ in range(2):
        runner._train_step(img, gt, generator)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        runner._train_step(img, gt, generator)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / iters
    epochs_s = sum(run['epoch_s'])
    return dict(step_alone_ms=step_ms, step_alone_steps=2 + iters,
                host_share=(epochs_s - len(run['logs']) * step_ms / 1e3) /
                epochs_s)


def _resume_check(runner, run, cfg_path, wd, work, at, args):
    """A second run from ``epoch_{at}.pth`` to the last epoch, against the
    unbroken ``runner``: its first step's losses (the same weights, batch
    and dropout draw; rtol 1e-5) and its final parameters, whose largest
    difference is given beside the Adam band 2·steps·lr (its bound on
    how far noise-signed moves of two runs can part)."""
    resumed, rerun, seconds = _train(
        [cfg_path, '--work-dir', osp.join(work, 'resumed'), '--no-validate',
         '--seed', '0', '--resume-from', osp.join(wd, f'epoch_{at}.pth')],
        args.device)
    first = rerun['first_iter']
    steps = len(rerun['logs'])
    loss_err = {k: abs(v[0] - run['losses'][k][first]) /
                max(abs(run['losses'][k][first]), 1e-12)
                for k, v in rerun['losses'].items() if 'loss' in k}
    whole = dict(runner.model.named_parameters())
    param_err = max((p.detach() - whole[k].detach()).abs().max().item()
                    for k, p in resumed.model.named_parameters())
    band = 2 * steps * 3e-4
    state = resumed.optimizer.state[next(resumed.model.parameters())]
    return dict(from_epoch=at, first_iter=first, steps=steps,
                seconds=seconds, first_step_loss_rel_err=loss_err,
                params_max_abs_err=param_err, params_band=band,
                exp_avg_device=str(state['exp_avg'].device),
                epoch=resumed.epoch, iter=resumed.iter)


if __name__ == '__main__':
    main()
