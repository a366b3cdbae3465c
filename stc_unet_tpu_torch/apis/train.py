"""Training API (≙ ``stc_unet_tpu/apis/train.py``): ``init_random_seed``,
``set_random_seed`` and ``train_segmentor``.

``train_segmentor`` builds the seeded train loader (each sample's draws
from (seed, epoch, rank, position), ``datasets/builder.py``), with
``data.device_pipeline`` a ``DeviceBatchLoader`` around it (the
augmentation on the card, ``datasets/device_pipeline.py``), the
``torch.optim`` optimizer and the lr schedule (``by_epoch`` counts the
iterations of an epoch from the loader), the runner with its hooks, and
with ``validate`` an ``EvalHook`` over the val split, then runs the
workflow. It trains on the card unless the caller asks for the CPU
(``device='cpu'``); without CUDA it raises.

``distributed=True`` trains one rank of a data-parallel run (one process
a card, the process group joined by ``utils.init_dist``): the rank's
shard of the train split in batches of ``samples_per_gpu``, the train
step over ``default_data_mesh()`` (global-batch BN, averaged gradients),
and a ``DistEvalHook`` over the val split's shards.
"""
from __future__ import annotations

import random
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.datasets import (build_dataloader, build_dataset,
                                         wrap_loader_with_device_pipeline)
from stc_unet_tpu_torch.engine import (DistEvalHook, EvalHook,
                                       build_runner, find_latest_checkpoint)
from stc_unet_tpu_torch.utils.logger import get_root_logger
from stc_unet_tpu_torch.utils.util_distribution import (default_data_mesh,
                                                        sync_random_seed)


def init_random_seed(seed: Optional[int] = None, device=None) -> int:
    """``seed``, or one drawn from the global ``np.random``: rank 0's,
    broadcast, in a process group of more than one rank."""
    if seed is not None:
        return seed
    return sync_random_seed()


def set_random_seed(seed: int, deterministic: bool = False):
    """Seed Python's, numpy's and torch's global generators (the CPU's and
    every card's). ``deterministic`` sets ``cudnn.deterministic`` and
    clears ``cudnn.benchmark``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def train_device(device=None) -> torch.device:
    """``device`` (default ``'cuda'``); raises for CUDA without a card
    rather than falling back to the CPU."""
    device = torch.device(device or 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("train_segmentor: CUDA is not available; pass "
                           "device='cpu' (the CLI's --device cpu) to train "
                           "on the CPU")
    return device


def _refuse_unported(cfg, distributed):
    if len(cfg.get('gpu_ids') or [0]) > 1:
        raise NotImplementedError(
            'one process drives one card: launch a process a card with '
            'python -m torch.distributed.run --nproc_per_node N -m '
            'stc_unet_tpu_torch.tools.train CONFIG --launcher pytorch')
    if distributed and not dist.is_initialized():
        raise RuntimeError('train_segmentor(distributed=True) needs the '
                           'process group of the ranks: call '
                           'utils.init_dist first')


def _device_pipeline(cfg, data_loaders, datasets, seed, device, logger):
    """Wrap each loader in a ``DeviceBatchLoader`` on ``device``
    (``data.device_pipeline_size`` the static host size,
    ``data.device_pipeline_prefetch`` its batches in flight, default 2).
    A pipeline the device program cannot express warns and keeps its
    host loader, as in the JAX package; a failure of the program itself
    raises."""
    for i, (loader, ds) in enumerate(zip(data_loaders, datasets)):
        try:
            data_loaders[i] = wrap_loader_with_device_pipeline(
                loader, ds, cfg.data.train['pipeline'],
                host_size=cfg.data.get('device_pipeline_size'), seed=seed,
                prefetch=cfg.data.get('device_pipeline_prefetch', 2),
                device=device)
            logger.info('device_pipeline: augmentation on %s for loader %d',
                        device, i)
        except (ValueError, KeyError) as e:
            warnings.warn(f'device_pipeline requested but the train '
                          f'pipeline is not device-expressible ({e}); '
                          'falling back to the host pipeline')


def train_segmentor(model, dataset, cfg, distributed=False, validate=False,
                    timestamp=None, meta=None, device=None):
    """Train ``model`` (a port segmentor) on ``dataset`` (one, or one per
    workflow entry) as ``cfg`` says; returns the runner. ``device``
    (default ``'cuda'``) is where it trains."""
    _refuse_unported(cfg, distributed)
    device = train_device(device)
    logger = get_root_logger(log_level=cfg.get('log_level', 'INFO'))
    dataset = dataset if isinstance(dataset, (list, tuple)) else [dataset]
    seed = cfg.get('seed', 0) or 0
    data_loaders = [
        build_dataloader(ds, cfg.data.samples_per_gpu,
                         cfg.data.workers_per_gpu, num_gpus=1,
                         dist=distributed, seed=seed, drop_last=False)
        for ds in dataset]
    if cfg.data.get('device_pipeline'):
        _device_pipeline(cfg, data_loaders, dataset, seed, device, logger)

    model = model.to(device, memory_format=torch.channels_last)
    runner_cfg = dict(cfg.runner) if cfg.get('runner') else dict(
        type='IterBasedRunner', max_iters=cfg.total_iters)
    iters_per_epoch = len(data_loaders[0])
    if runner_cfg['type'] == 'EpochBasedRunner':
        max_iters = runner_cfg['max_epochs'] * iters_per_epoch
    else:
        max_iters = runner_cfg['max_iters']
    schedule = build_lr_schedule(cfg.get('lr_config'), cfg.optimizer['lr'],
                                 max_iters, iters_per_epoch)
    optimizer = build_optimizer(model, cfg.optimizer)
    # mixed precision: fp16 and bf16 configs both compute in bf16, as the
    # JAX package does
    compute_dtype = torch.bfloat16 if (cfg.get('fp16') is not None or
                                       cfg.get('bf16') is not None) else None
    runner = build_runner(
        runner_cfg,
        default_args=dict(model=model, optimizer=optimizer,
                          lr_schedule=schedule, work_dir=cfg.work_dir,
                          logger=logger, meta=meta, seed=seed,
                          compute_dtype=compute_dtype,
                          mesh=default_data_mesh() if distributed
                          else None,
                          remat=bool(cfg.get('remat', False))))
    if timestamp is not None:
        runner.timestamp = timestamp

    runner.register_training_hooks(
        lr_config=cfg.get('lr_config'),
        optimizer_config=cfg.get('optimizer_config'),
        checkpoint_config=cfg.get('checkpoint_config'),
        log_config=cfg.get('log_config'),
        momentum_config=cfg.get('momentum_config'),
        custom_hooks_config=cfg.get('custom_hooks'))
    runner.register_hook_from_cfg(dict(type='DistSamplerSeedHook'))

    if validate:
        val_dataset = build_dataset(cfg.data.val, dict(test_mode=True))
        val_dataloader = build_dataloader(
            val_dataset, samples_per_gpu=1,
            workers_per_gpu=cfg.data.workers_per_gpu, dist=distributed,
            shuffle=False)
        eval_cfg = dict(cfg.get('evaluation', {}))
        eval_cfg['by_epoch'] = runner_cfg['type'] != 'IterBasedRunner'
        eval_hook = DistEvalHook if distributed else EvalHook
        runner.register_hook(eval_hook(val_dataloader, **eval_cfg),
                             priority='LOW')

    if cfg.get('auto_resume'):
        # the port's latest.pth; else the newest .ckpt of a JAX run
        resume_from = find_latest_checkpoint(cfg.work_dir) or \
            find_latest_checkpoint(cfg.work_dir, 'ckpt')
        if resume_from is not None:
            logger.info(f'auto-resume from {resume_from}')
            cfg.resume_from = resume_from
    if cfg.get('resume_from'):
        runner.resume(cfg.resume_from)
    elif cfg.get('load_from'):
        runner.load_checkpoint(cfg.load_from)
    runner.run(data_loaders, cfg.workflow)
    return runner
