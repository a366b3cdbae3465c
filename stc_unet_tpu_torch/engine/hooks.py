"""Hooks (≙ ``stc_unet_tpu/engine/hooks.py``): the mmcv lifecycle
(before_run, before_train_epoch, ..., after_run) and priorities, so the
reference's ``log_config``, ``checkpoint_config`` and ``evaluation`` port
unchanged.

The step's log values stay 0-dim tensors on the card: ``LogBuffer`` reads
them back once, at ``average()``, in one transfer, so the loop never waits
on the card between logging intervals.
"""
from __future__ import annotations

import datetime
import json
import os.path as osp
import time

import numpy as np
import torch

from stc_unet_tpu_torch.utils import Registry

HOOKS = Registry('hook')

PRIORITIES = {
    'HIGHEST': 0, 'VERY_HIGH': 10, 'HIGH': 30, 'ABOVE_NORMAL': 40,
    'NORMAL': 50, 'BELOW_NORMAL': 60, 'LOW': 70, 'VERY_LOW': 90,
    'LOWEST': 100,
}


def get_priority(priority) -> int:
    if isinstance(priority, int):
        if not 0 <= priority <= 100:
            raise ValueError(f'priority {priority} not in [0, 100]')
        return priority
    return PRIORITIES[priority]


class Hook:
    stages = ('before_run', 'before_train_epoch', 'before_train_iter',
              'after_train_iter', 'after_train_epoch', 'before_val_epoch',
              'before_val_iter', 'after_val_iter', 'after_val_epoch',
              'after_run', 'before_epoch', 'after_epoch', 'before_iter',
              'after_iter')

    def before_run(self, runner):
        pass

    def after_run(self, runner):
        pass

    def before_epoch(self, runner):
        pass

    def after_epoch(self, runner):
        pass

    def before_iter(self, runner):
        pass

    def after_iter(self, runner):
        pass

    def before_train_epoch(self, runner):
        self.before_epoch(runner)

    def before_val_epoch(self, runner):
        self.before_epoch(runner)

    def after_train_epoch(self, runner):
        self.after_epoch(runner)

    def after_val_epoch(self, runner):
        self.after_epoch(runner)

    def before_train_iter(self, runner):
        self.before_iter(runner)

    def before_val_iter(self, runner):
        self.before_iter(runner)

    def after_train_iter(self, runner):
        self.after_iter(runner)

    def after_val_iter(self, runner):
        self.after_iter(runner)

    def every_n_epochs(self, runner, n):
        return (runner.epoch + 1) % n == 0 if n > 0 else False

    def every_n_inner_iters(self, runner, n):
        return (runner.inner_iter + 1) % n == 0 if n > 0 else False

    def every_n_iters(self, runner, n):
        return (runner.iter + 1) % n == 0 if n > 0 else False

    def end_of_epoch(self, runner):
        return runner.inner_iter + 1 == len(runner.data_loader)

    def is_last_epoch(self, runner):
        return runner.epoch + 1 == runner.max_epochs

    def is_last_iter(self, runner):
        return runner.iter + 1 == runner.max_iters


class LogBuffer:
    """Average-by-count buffer of log values (mmcv ``LogBuffer``). Values
    may be Python numbers or 0-dim tensors on any device; ``average``
    reads every tensor of the averaged tails back in one transfer."""

    def __init__(self):
        self.val_history = {}
        self.n_history = {}
        self.output = {}
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        for key, var in vars.items():
            self.val_history.setdefault(key, []).append(var)
            self.n_history.setdefault(key, []).append(count)

    def average(self, n: int = 0):
        """Average the latest n values of each key (0: all)."""
        tails = {key: (values[-n:] if n else values)
                 for key, values in self.val_history.items()}
        tensors = [v for values in tails.values() for v in values
                   if torch.is_tensor(v)]
        host = iter(torch.stack([t.detach().float().reshape(())
                                 for t in tensors]).cpu().tolist()
                    if tensors else [])
        for key, values in tails.items():
            values = np.array([next(host) if torch.is_tensor(v) else v
                               for v in values], np.float64)
            nums = np.array(self.n_history[key][-n:] if n
                            else self.n_history[key])
            self.output[key] = float(np.sum(values * nums) / np.sum(nums))
        self.ready = True


@HOOKS.register_module()
class IterTimerHook(Hook):
    """``data_time`` (waiting for the batch) and ``time`` (the whole
    iteration) on the host's clock, into the log buffer."""

    def before_epoch(self, runner):
        self.t = time.time()

    def before_iter(self, runner):
        runner.log_buffer.update({'data_time': time.time() - self.t})

    def after_iter(self, runner):
        runner.log_buffer.update({'time': time.time() - self.t})
        self.t = time.time()


@HOOKS.register_module()
class TextLoggerHook(Hook):
    """Log the averaged values, the lr and the ETA every ``interval``
    iterations, to the logger and as one JSON line each to
    ``<work_dir>/<timestamp>.log.json`` (rank 0's only), with the JAX
    package's keys: ``mode, epoch, iter, lr``, the buffer's keys and
    ``eta``."""

    def __init__(self, by_epoch=True, interval=10, ignore_last=True):
        self.by_epoch = by_epoch
        self.interval = interval
        self.ignore_last = ignore_last
        self.json_log_path = None

    def before_run(self, runner):
        self.start_iter = runner.iter
        if runner.work_dir is not None and runner.timestamp is not None \
                and runner.rank == 0:
            self.json_log_path = osp.join(runner.work_dir,
                                          f'{runner.timestamp}.log.json')

    def before_epoch(self, runner):
        # an epoch's averages must not mix in the previous epoch's history
        runner.log_buffer.clear()

    def _log_json(self, record: dict):
        if self.json_log_path is None:
            return
        with open(self.json_log_path, 'a+') as f:
            json.dump({k: (round(v, 5) if isinstance(v, float) else v)
                       for k, v in record.items()}, f)
            f.write('\n')

    def _log(self, runner, mode: str):
        runner.log_buffer.average(self.interval)
        out = dict(runner.log_buffer.output)
        lr = runner.current_lr()
        record = dict(mode=mode, epoch=runner.epoch + 1, iter=runner.iter + 1,
                      lr=float(lr) if lr is not None else 0.0)
        record.update(out)
        if mode == 'train':
            head = (f'Epoch [{runner.epoch + 1}]'
                    f'[{runner.inner_iter + 1}/{len(runner.data_loader)}]'
                    if self.by_epoch else
                    f'Iter [{runner.iter + 1}/{runner.max_iters}]')
            if 'time' in out:
                eta_sec = out['time'] * (runner.max_iters - runner.iter - 1)
                record['eta'] = str(
                    datetime.timedelta(seconds=int(eta_sec)))
        else:
            head = f'Epoch({mode}) [{runner.epoch + 1}]' \
                   f'[{runner.inner_iter + 1}]'
        kv = ', '.join(f'{k}: {v:.4f}' if isinstance(v, float) else f'{k}: {v}'
                       for k, v in record.items()
                       if k not in ('mode', 'epoch', 'iter'))
        runner.logger.info(f'{head}\t{kv}')
        self._log_json(record)
        runner.log_buffer.clear_output()

    def after_train_iter(self, runner):
        if self.by_epoch and self.every_n_inner_iters(runner, self.interval):
            self._log(runner, 'train')
        elif not self.by_epoch and self.every_n_iters(runner, self.interval):
            self._log(runner, 'train')
        elif self.end_of_epoch(runner) and not self.ignore_last:
            self._log(runner, 'train')

    def after_val_epoch(self, runner):
        runner.log_buffer.average()
        out = dict(runner.log_buffer.output)
        kv = ', '.join(f'{k}: {v:.4f}' for k, v in out.items())
        runner.logger.info(f'Epoch(val) [{runner.epoch}]\t{kv}')
        record = dict(mode='val', epoch=runner.epoch + 1, iter=runner.iter)
        record.update(out)
        self._log_json(record)
        runner.log_buffer.clear_output()


@HOOKS.register_module()
class TensorboardLoggerHook(Hook):
    """TensorBoard scalars every ``interval`` iterations, on rank 0; a
    warning and nothing else when ``torch.utils.tensorboard`` cannot be
    imported (the tensorboard package is missing)."""

    def __init__(self, log_dir=None, interval=10, by_epoch=True):
        self.log_dir = log_dir
        self.interval = interval
        self.by_epoch = by_epoch
        self.writer = None

    def before_run(self, runner):
        if runner.rank != 0:
            return
        log_dir = self.log_dir or osp.join(runner.work_dir, 'tf_logs')
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except ImportError:
            runner.logger.warning(
                'tensorboard is not installed; TensorboardLoggerHook is a '
                'no-op')

    def after_train_iter(self, runner):
        if self.writer is None:
            return
        if self.every_n_iters(runner, self.interval):
            runner.log_buffer.average(self.interval)
            for k, v in runner.log_buffer.output.items():
                self.writer.add_scalar(f'train/{k}', v, runner.iter + 1)
            lr = runner.current_lr()
            if lr is not None:
                self.writer.add_scalar('learning_rate', lr, runner.iter + 1)

    def after_run(self, runner):
        if self.writer is not None:
            self.writer.close()


@HOOKS.register_module()
class CheckpointHook(Hook):
    """Save ``epoch_{n}.pth`` (or ``iter_{n}.pth``) every ``interval``
    epochs (iterations) and at the last one with ``save_last``, through
    ``runner.save_checkpoint``; ``max_keep_ckpts`` > 0 keeps that many."""

    def __init__(self, interval=-1, by_epoch=True, save_optimizer=True,
                 out_dir=None, max_keep_ckpts=-1, save_last=True, meta=None):
        self.interval = interval
        self.by_epoch = by_epoch
        self.save_optimizer = save_optimizer
        self.out_dir = out_dir
        self.max_keep_ckpts = max_keep_ckpts
        self.save_last = save_last
        self.meta = meta

    def before_run(self, runner):
        if not self.out_dir:
            self.out_dir = runner.work_dir

    def _save(self, runner):
        runner.save_checkpoint(self.out_dir, save_optimizer=self.save_optimizer,
                               by_epoch=self.by_epoch, meta=self.meta,
                               max_keep_ckpts=self.max_keep_ckpts)

    def after_train_epoch(self, runner):
        if not self.by_epoch:
            return
        if self.every_n_epochs(runner, self.interval) or (
                self.save_last and self.is_last_epoch(runner)):
            self._save(runner)

    def after_train_iter(self, runner):
        if self.by_epoch:
            return
        if self.every_n_iters(runner, self.interval) or (
                self.save_last and self.is_last_iter(runner)):
            self._save(runner)


@HOOKS.register_module()
class DistSamplerSeedHook(Hook):
    """Hand the runner's epoch to the loader, whose sampler keys its
    permutation (and each sample's draws) on it."""

    def before_epoch(self, runner):
        if hasattr(runner.data_loader, 'set_epoch'):
            runner.data_loader.set_epoch(runner.epoch)
