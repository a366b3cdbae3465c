"""Extra hooks (≙ ``stc_unet_tpu/engine/extra_hooks.py``): Weights & Biases
logging, and a ``torch.profiler`` trace of a window of train steps, the
counterpart of the JAX package's ``JaxProfilerHook``."""
from __future__ import annotations

import os
import os.path as osp

import torch

from .hooks import HOOKS, Hook


@HOOKS.register_module()
class MMSegWandbHook(Hook):
    """Weights & Biases logging (≙ the JAX ``MMSegWandbHook``): ``wandb.init
    (**init_kwargs)`` and the experiment name at the start, the log
    buffer's averages every ``interval`` train iterations, and with
    ``log_checkpoint`` the work dir's ``latest.pth`` as a model artifact
    after each epoch (with the epoch and iteration as its metadata when
    ``log_checkpoint_metadata``). ``num_eval_images`` is accepted for the
    reference's configs; as in the JAX package no images are logged.
    wandb is imported when the run starts; without it the hook warns and
    does nothing. In a data-parallel run only rank 0 logs."""

    def __init__(self, init_kwargs=None, interval=50, log_checkpoint=False,
                 log_checkpoint_metadata=False, num_eval_images=100):
        self.init_kwargs = init_kwargs or {}
        self.interval = interval
        self.log_checkpoint = log_checkpoint
        self.log_checkpoint_metadata = log_checkpoint_metadata
        self.wandb = None

    def before_run(self, runner):
        if runner.rank != 0:
            return
        try:
            import wandb
        except ImportError:
            runner.logger.warning(
                'wandb is not installed; MMSegWandbHook does nothing')
            return
        self.wandb = wandb
        wandb.init(**self.init_kwargs)
        if 'exp_name' in runner.meta:
            wandb.config.update({'exp_name': runner.meta['exp_name']})

    def after_train_iter(self, runner):
        if self.wandb is None or not self.every_n_iters(runner,
                                                        self.interval):
            return
        runner.log_buffer.average(self.interval)
        self.wandb.log(dict(runner.log_buffer.output), step=runner.iter + 1)

    def after_train_epoch(self, runner):
        if self.wandb is None or not self.log_checkpoint:
            return
        latest = osp.join(runner.work_dir, 'latest.pth')
        if not osp.exists(latest):
            return
        metadata = dict(epoch=runner.epoch + 1, iter=runner.iter) \
            if self.log_checkpoint_metadata else None
        art = self.wandb.Artifact(f'run_{self.wandb.run.id}_model',
                                  type='model', metadata=metadata)
        art.add_file(latest)
        self.wandb.log_artifact(art)

    def after_run(self, runner):
        if self.wandb is not None:
            self.wandb.finish()


@HOOKS.register_module()
class TorchProfilerHook(Hook):
    """A ``torch.profiler`` trace of ``num_iters`` train iterations from
    iteration ``start_iter`` (0-based), written as a Chrome trace
    (``trace_iter_<first>-<last>.json``, opened by Perfetto or
    chrome://tracing) under ``log_dir`` (default ``<work_dir>/profile``):
    the card's kernels when the model is on the card, else the host's ops.
    The path of the trace is kept in ``trace_file``. In a data-parallel
    run rank 0 traces."""

    def __init__(self, start_iter=10, num_iters=5, log_dir=None):
        self.start_iter = start_iter
        self.num_iters = num_iters
        self.log_dir = log_dir
        self.trace_file = None
        self._prof = None

    def before_train_iter(self, runner):
        if runner.iter != self.start_iter or self._prof is not None or \
                runner.rank != 0:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if runner.device.type == 'cuda'
            else ProfilerActivity.CPU])
        self._prof.__enter__()

    def after_train_iter(self, runner):
        if self._prof is not None and \
                runner.iter >= self.start_iter + self.num_iters - 1:
            self._stop(runner)

    def after_run(self, runner):
        if self._prof is not None:       # the run ended inside the window
            self._stop(runner)

    def _stop(self, runner):
        if runner.device.type == 'cuda':
            torch.cuda.synchronize(runner.device)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        log_dir = self.log_dir or osp.join(runner.work_dir, 'profile')
        os.makedirs(log_dir, exist_ok=True)
        self.trace_file = osp.join(
            log_dir, f'trace_iter_{self.start_iter}-{runner.iter}.json')
        prof.export_chrome_trace(self.trace_file)
        runner.logger.info(f'profiler trace written to {self.trace_file}')
