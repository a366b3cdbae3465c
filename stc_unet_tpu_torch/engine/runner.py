"""Runners (≙ ``stc_unet_tpu/engine/runner.py``, itself mmcv's
``EpochBasedRunner`` and ``IterBasedRunner``).

The runner owns the host loop: epoch and iteration counts, the hooks,
checkpoints and resuming. The device work is ``engine.make_train_step``
(forward, backward and the optimizer step in place) with the lr schedule
``lr_schedule(k)`` of the 0-based iteration ``k``; there is no
OptimizerHook. Each batch is staged in pinned memory and copied to the
card with ``non_blocking=True``. Dropout masks come from a
``torch.Generator`` on the model's device, seeded from (``seed``, the
iteration, the rank) before each step, so a resumed run draws what an
unbroken one draws, and the ranks of a data-parallel run draw apart.

In a data-parallel run (a ``mesh``, one process a card) every rank runs
the loop and its hooks, but only rank 0 writes checkpoints,
``latest.pth``, the log file and the JSON log (mmcv's ``master_only``):
the ranks share the work dir. The JAX runner needs no such guard, since
one JAX process drives all of a host's devices.

A checkpoint's ``meta`` counts what is done: ``epoch`` the epochs begun
(``runner.epoch + 1``, as in the JAX package) and ``iter`` the iterations
taken (the JAX package writes one more at an epoch's end; mmcv writes
this). ``resume`` takes both back, from the port's ``.pth`` or from a JAX
``.ckpt``, whose ``step`` counts the iterations taken.
"""
from __future__ import annotations

import os
import os.path as osp
import shutil
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from stc_unet_tpu_torch.utils.logger import get_root_logger
from stc_unet_tpu_torch.utils.util_distribution import get_dist_info
from .checkpoint import load_checkpoint, load_opt_state, save_checkpoint
from .hooks import HOOKS, Hook, LogBuffer, get_priority
from .train_state import make_train_step, make_val_step

RUNNERS = {}


def register_runner(cls):
    RUNNERS[cls.__name__] = cls
    return cls


def build_runner(cfg: dict, default_args: Optional[dict] = None):
    cfg = dict(cfg)
    runner_type = cfg.pop('type')
    if runner_type not in RUNNERS:
        raise KeyError(f'Unknown runner type {runner_type}')
    return RUNNERS[runner_type](**cfg, **(default_args or {}))


class BaseRunner:
    """Shared runner machinery. ``model`` is a port segmentor on its
    device, ``optimizer`` a ``torch.optim`` optimizer over its parameters
    (``core.build_optimizer``), ``lr_schedule`` a ``schedule(k) -> lr``
    (``core.build_lr_schedule``) or None to keep the groups' lr,
    ``mesh`` the data mesh of a data-parallel run and ``remat`` the
    rematerialised step (``engine.make_train_step``)."""

    def __init__(self, model, optimizer, lr_schedule: Optional[Callable] = None,
                 work_dir=None, logger=None, meta=None, max_epochs=None,
                 max_iters=None, seed=0, compute_dtype=None, mesh=None,
                 remat=False):
        self.model = model
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.work_dir = work_dir
        if work_dir is not None:
            os.makedirs(work_dir, exist_ok=True)
        self.logger = logger or get_root_logger()
        self.meta = {} if meta is None else meta
        self._max_epochs = max_epochs
        self._max_iters = max_iters
        self.epoch = 0
        self.iter = 0
        self.inner_iter = 0
        self._iters_done = 0
        self.mode = None
        self._hooks: List[Hook] = []
        self.log_buffer = LogBuffer()
        self.data_loader = None
        self.data_batch = None
        self.outputs = None
        self.timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
        self.seed = int(seed or 0)
        self.rank, self.world_size = get_dist_info()
        self.device = next(model.parameters()).device
        self._generator = torch.Generator(device=self.device)
        # the step counts from 0 in its closure; a resumed run's schedule
        # starts at the resumed iteration
        self._schedule_base = 0
        schedule = None if lr_schedule is None else \
            (lambda k: lr_schedule(self._schedule_base + k))
        self._train_step = make_train_step(model, optimizer, schedule,
                                           compute_dtype=compute_dtype,
                                           mesh=mesh, remat=remat)
        self._val_step = make_val_step(model, mesh=mesh)

    # -- properties ----------------------------------------------------------
    @property
    def max_epochs(self):
        return self._max_epochs

    @property
    def max_iters(self):
        return self._max_iters

    @property
    def hooks(self):
        return self._hooks

    def current_lr(self):
        if self.lr_schedule is None:
            return self.optimizer.param_groups[0]['lr']
        return float(self.lr_schedule(self.iter))

    # -- hooks ---------------------------------------------------------------
    def register_hook(self, hook: Hook, priority='NORMAL'):
        priority = get_priority(priority)
        hook.priority = priority
        for i in range(len(self._hooks) - 1, -1, -1):
            if priority >= self._hooks[i].priority:
                self._hooks.insert(i + 1, hook)
                return
        self._hooks.insert(0, hook)

    def register_hook_from_cfg(self, hook_cfg: dict):
        hook_cfg = dict(hook_cfg)
        priority = hook_cfg.pop('priority', 'NORMAL')
        hook = HOOKS.build(hook_cfg)
        self.register_hook(hook, priority=priority)
        return hook

    def call_hook(self, fn_name: str):
        for hook in self._hooks:
            getattr(hook, fn_name)(self)

    def register_training_hooks(self, lr_config=None, optimizer_config=None,
                                checkpoint_config=None, log_config=None,
                                momentum_config=None,
                                timer_config=dict(type='IterTimerHook'),
                                custom_hooks_config=None):
        """The reference's hook registration. ``lr_config`` and
        ``optimizer_config`` register nothing: the lr schedule and the
        update are the train step's. ``momentum_config`` raises."""
        if momentum_config is not None:
            raise NotImplementedError(
                'momentum_config (a momentum schedule) is not ported: the '
                'flagship configs have none')
        if timer_config is not None:
            self.register_hook_from_cfg(dict(timer_config))
        if checkpoint_config is not None:
            cfg = dict(checkpoint_config)
            cfg.setdefault('type', 'CheckpointHook')
            self.register_hook(HOOKS.build(cfg), priority='NORMAL')
        if log_config is not None:
            interval = log_config.get('interval', 10)
            for info in log_config['hooks']:
                cfg = dict(info)
                cfg.setdefault('interval', interval)
                cfg.setdefault('by_epoch', isinstance(self, EpochBasedRunner))
                self.register_hook(HOOKS.build(cfg), priority='VERY_LOW')
        for c in (custom_hooks_config or []):
            self.register_hook_from_cfg(dict(c))

    # -- checkpointing -------------------------------------------------------
    def save_checkpoint(self, out_dir, filename_tmpl=None,
                        save_optimizer=True, meta=None, by_epoch=True,
                        create_symlink=True, max_keep_ckpts=-1):
        """Write ``epoch_{n}.pth`` (or ``iter_{n}.pth``) to ``out_dir``,
        point ``latest.pth`` at it (a copy where links fail) and keep the
        newest ``max_keep_ckpts`` (all when <= 0); return its path. Only
        rank 0 writes (the others return None)."""
        if self.rank != 0:
            return None
        prefix = 'epoch_' if by_epoch else 'iter_'
        number = self.epoch + 1 if by_epoch else self._iters_done
        name = (filename_tmpl or prefix + '{}.pth').format(number)
        meta = dict(meta or {})
        meta.update({k: v for k, v in self.meta.items() if k != 'env_info'})
        meta.update(epoch=self.epoch + 1, iter=self._iters_done)
        filepath = osp.join(out_dir, name)
        save_checkpoint(self.model, filepath,
                        optimizer=self.optimizer if save_optimizer else None,
                        meta=meta)
        if create_symlink:
            latest = osp.join(out_dir, 'latest.pth')
            if osp.lexists(latest):
                os.remove(latest)
            try:
                os.symlink(name, latest)
            except OSError:
                shutil.copy(filepath, latest)
        if max_keep_ckpts > 0:
            ids = []
            for f in os.listdir(out_dir):
                stem = f[len(prefix):-len('.pth')]
                if f.startswith(prefix) and f.endswith('.pth') and \
                        stem.isdigit():
                    ids.append(int(stem))
            for cid in sorted(ids)[:-max_keep_ckpts]:
                os.remove(osp.join(out_dir, f'{prefix}{cid}.pth'))
        self.logger.info(f'Saved checkpoint to {filepath}')
        return filepath

    def load_checkpoint(self, filename):
        """The weights of a ``.pth`` or a JAX ``.ckpt`` (``load_from``)."""
        ckpt = load_checkpoint(self.model, filename)
        self.logger.info(f'Loaded checkpoint from {filename}')
        return ckpt

    def resume(self, checkpoint, resume_optimizer=True):
        """Weights, optimizer state (with ``resume_optimizer``, where the
        file has one) and the epoch and iteration counts of one of the
        port's ``.pth`` files or of a JAX ``.ckpt``. A ``.ckpt``'s
        iterations are its ``step``, its optax ``opt_state`` goes through
        ``load_opt_state``, and the BN layers' ``num_batches_tracked``
        (which flax does not keep) is set to the step, as an unbroken
        run of the port would have it. The lr schedule goes on from the
        iteration count."""
        ckpt = self.load_checkpoint(checkpoint)
        meta = ckpt.get('meta') or {}
        self.epoch = int(meta.get('epoch', 0))
        if 'variables' in ckpt:                  # a JAX .ckpt
            self.iter = self._iters_done = int(ckpt['step'])
            for name, buf in self.model.named_buffers():
                if name.endswith('num_batches_tracked'):
                    buf.fill_(self.iter)
            if resume_optimizer and 'opt_state' in ckpt:
                load_opt_state(self.optimizer, self.model, ckpt['opt_state'])
        else:
            self.iter = self._iters_done = int(meta.get('iter', 0))
            if resume_optimizer and 'optimizer' in ckpt:
                self.optimizer.load_state_dict(ckpt['optimizer'])
        self._schedule_base = self.iter
        self.logger.info(f'resumed epoch {self.epoch}, iter {self.iter}')

    # -- core steps ----------------------------------------------------------
    def _stage(self, array):
        """A batch array on the model's device: through pinned memory and
        a non-blocking copy for a CUDA device."""
        t = array if torch.is_tensor(array) else \
            torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == 'cuda' and t.device.type == 'cpu':
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def run_iter(self, data_batch, train_mode: bool):
        img = self._stage(data_batch['img'])
        gt = self._stage(data_batch['gt_semantic_seg'])
        self.data_batch = dict(data_batch, img=img, gt_semantic_seg=gt)
        if train_mode:
            self._generator.manual_seed(
                ((self.seed * 1_000_003 + self.iter) * self.world_size +
                 self.rank) % 2 ** 63)
            log_vars = self._train_step(img, gt, self._generator)
            self._iters_done = self.iter + 1
        else:
            log_vars = self._val_step(img, gt)
        # by key, as the JAX step returns them (jit sorts a dict's keys):
        # the log lines list them in this order
        log_vars = dict(sorted(log_vars.items()))
        self.log_buffer.update(log_vars, count=len(img))
        self.outputs = dict(log_vars=log_vars, num_samples=len(img))


@register_runner
class EpochBasedRunner(BaseRunner):
    """Runs ``max_epochs`` epochs of the workflow (the flagship's
    runner, ``my_config/_base_kits19.py``)."""

    def train(self, data_loader, **kwargs):
        self.mode = 'train'
        self.data_loader = data_loader
        if self._max_iters is None:
            self._max_iters = self._max_epochs * len(data_loader)
        self.call_hook('before_train_epoch')
        if hasattr(data_loader, 'set_epoch'):
            data_loader.set_epoch(self.epoch)
        for i, data_batch in enumerate(data_loader):
            self.inner_iter = i
            self.call_hook('before_train_iter')
            self.run_iter(data_batch, train_mode=True)
            self.call_hook('after_train_iter')
            self.iter += 1
        self.call_hook('after_train_epoch')
        self.epoch += 1

    def val(self, data_loader, **kwargs):
        self.mode = 'val'
        self.data_loader = data_loader
        self.call_hook('before_val_epoch')
        for i, data_batch in enumerate(data_loader):
            self.inner_iter = i
            self.call_hook('before_val_iter')
            self.run_iter(data_batch, train_mode=False)
            self.call_hook('after_val_iter')
        self.call_hook('after_val_epoch')

    def run(self, data_loaders, workflow, max_epochs=None, **kwargs):
        """``workflow``, e.g. ``[('train', 1)]``, over ``data_loaders``
        (one per entry) until ``max_epochs``."""
        if len(data_loaders) != len(workflow):
            raise ValueError('one data loader per workflow entry')
        if max_epochs is not None:
            self._max_epochs = max_epochs
        if self._max_epochs is None:
            raise ValueError('EpochBasedRunner: max_epochs is not set')
        for i, (mode, _) in enumerate(workflow):
            if mode == 'train':
                self._max_iters = self._max_epochs * len(data_loaders[i])
                break
        self.logger.info('workflow: %s, max: %d epochs', workflow,
                         self._max_epochs)
        self.call_hook('before_run')
        while self.epoch < self._max_epochs:
            for i, (mode, epochs) in enumerate(workflow):
                epoch_runner = getattr(self, mode)
                for _ in range(epochs):
                    if mode == 'train' and self.epoch >= self._max_epochs:
                        break
                    epoch_runner(data_loaders[i], **kwargs)
        self.call_hook('after_run')


@register_runner
class IterBasedRunner(BaseRunner):
    """Runs ``max_iters`` iterations, the loaders cycling through epochs
    (each a new permutation)."""

    def run(self, data_loaders, workflow, max_iters=None, **kwargs):
        if len(data_loaders) != len(workflow):
            raise ValueError('one data loader per workflow entry')
        if max_iters is not None:
            self._max_iters = max_iters
        if self._max_iters is None:
            raise ValueError('IterBasedRunner: max_iters is not set')
        self.logger.info('workflow: %s, max: %d iters', workflow,
                         self._max_iters)
        self.call_hook('before_run')
        iter_loaders = [_InfiniteLoader(dl, self) for dl in data_loaders]
        self.call_hook('before_train_epoch')
        while self.iter < self._max_iters:
            for i, (mode, iters) in enumerate(workflow):
                for _ in range(iters):
                    if mode == 'train' and self.iter >= self._max_iters:
                        break
                    self.mode = mode
                    self.data_loader = iter_loaders[i].loader
                    if mode == 'train':
                        self.inner_iter = self.iter
                    self.call_hook(f'before_{mode}_iter')
                    self.run_iter(next(iter_loaders[i]),
                                  train_mode=mode == 'train')
                    self.call_hook(f'after_{mode}_iter')
                    if mode == 'train':
                        self.iter += 1
        self.call_hook('after_train_epoch')
        self.call_hook('after_run')

    def train(self, data_loader, **kwargs):
        raise NotImplementedError('IterBasedRunner is driven through run()')

    def val(self, data_loader, **kwargs):
        raise NotImplementedError('IterBasedRunner is driven through run()')


class _InfiniteLoader:
    """Cycles a loader through epochs, each with its own permutation."""

    def __init__(self, loader, runner):
        self.loader = loader
        self.runner = runner
        self._epoch = runner.epoch
        if hasattr(loader, 'set_epoch'):
            loader.set_epoch(self._epoch)
        self._it = iter(loader)

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._epoch += 1
            self.runner.epoch = self._epoch
            if hasattr(self.loader, 'set_epoch'):
                self.loader.set_epoch(self._epoch)
            self._it = iter(self.loader)
            return next(self._it)
