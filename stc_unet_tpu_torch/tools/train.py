"""Train a segmentor with the port (≙ ``tools/train.py``, the same argv):

    python -m stc_unet_tpu_torch.tools.train CONFIG [--work-dir D]
        [--load-from C] [--resume-from C] [--no-validate] [--seed N]
        [--deterministic] [--cfg-options K=V ...] [--auto-resume]
        [--device cuda|cpu] [--launcher none|pytorch]

It trains on the card (``--device cuda``, the default) and raises when
CUDA is missing rather than fall back to the CPU; ``--device cpu`` asks
for the CPU. ``--load-from`` and ``--resume-from`` take a ``.pth`` or a
JAX ``.ckpt`` (its optax state mapped onto ``torch.optim``'s);
``--auto-resume`` takes the work dir's ``latest.pth``, else its newest
``.ckpt``. ``data.img_cache='ram'|'disk'`` (and ``data.img_cache_dir``)
puts the loaders of the train and val splits behind the decoded-image
cache. The work dir gets the config, ``<timestamp>.log``,
``<timestamp>.log.json`` and the checkpoints (``epoch_{n}.pth``,
``latest.pth``).

Data-parallel training runs one process a card:

    python -m torch.distributed.run --nproc_per_node N \
        -m stc_unet_tpu_torch.tools.train CONFIG --launcher pytorch

Each rank joins the group with the config's ``dist_params`` (``backend``
``'jax'`` is NCCL on the card and gloo with ``--device cpu``; ``--cfg-
options dist_params.backend=gloo`` runs ranks that share one card) and
trains on ``cuda:LOCAL_RANK`` with ``samples_per_gpu`` images; rank 0
writes the work dir. ``--gpus`` or ``--gpu-ids`` of more than one card in
one process raise, as do the launchers other than ``pytorch``.
"""
from __future__ import annotations

import argparse
import ast
import copy
import os
import os.path as osp
import platform
import sys
import time

import numpy as np
import torch

import stc_unet_tpu_torch
from stc_unet_tpu_torch.apis import (init_random_seed, set_random_seed,
                                     train_device, train_segmentor)
from stc_unet_tpu_torch.datasets import build_dataset, inject_img_cache
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config
from stc_unet_tpu_torch.utils.logger import get_root_logger
from stc_unet_tpu_torch.utils.util_distribution import (get_dist_info,
                                                        init_dist)


class DictAction(argparse.Action):
    """``--cfg-options a.b=1 c=[2,3]`` → a dict (mmcv's DictAction)."""

    @staticmethod
    def _parse_value(val: str):
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            if val.lower() in ('true', 'false'):
                return val.lower() == 'true'
            return val

    def __call__(self, parser, namespace, values, option_string=None):
        options = {}
        for kv in values:
            key, val = kv.split('=', maxsplit=1)
            options[key] = self._parse_value(val)
        setattr(namespace, self.dest, options)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train a segmentor')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='the dir to save logs and models')
    parser.add_argument('--load-from', help='checkpoint to load weights from')
    parser.add_argument('--resume-from', help='checkpoint to resume from')
    parser.add_argument('--no-validate', action='store_true',
                        help='do not evaluate during training')
    parser.add_argument('--gpus', type=int,
                        help='(deprecated) number of GPUs')
    parser.add_argument('--gpu-ids', type=int, nargs='+',
                        help='(deprecated) ids of the GPUs to use')
    parser.add_argument('--seed', type=int, default=None, help='random seed')
    parser.add_argument('--deterministic', action='store_true',
                        help='cudnn.deterministic, no cudnn.benchmark')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='override settings, key=value pairs merged into '
                             'the config (nested keys via a.b.c=v)')
    parser.add_argument('--launcher',
                        choices=['none', 'pytorch', 'slurm', 'mpi', 'jax'],
                        default='none', help='job launcher')
    parser.add_argument('--local_rank', type=int, default=0)
    parser.add_argument('--auto-resume', action='store_true',
                        help='resume from the latest checkpoint '
                             'automatically')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='where to train (default: the card)')
    return parser.parse_args(argv)


def collect_env() -> dict:
    env = {'sys.platform': sys.platform,
           'Python': sys.version.replace('\n', ''),
           'CUDA available': torch.cuda.is_available(),
           'PyTorch': torch.__version__, 'NumPy': np.__version__,
           'stc_unet_tpu_torch': stc_unet_tpu_torch.__version__,
           'Machine': platform.machine()}
    if torch.cuda.is_available():
        env['CUDA'] = torch.version.cuda
        env['GPU 0'] = torch.cuda.get_device_name(0)
    return env


def main(argv=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    runner."""
    args = parse_args(argv)
    if (args.gpus or 1) > 1 or len(args.gpu_ids or [0]) > 1:
        raise NotImplementedError(
            'one process drives one card: launch a process a card with '
            'python -m torch.distributed.run --nproc_per_node N -m '
            'stc_unet_tpu_torch.tools.train CONFIG --launcher pytorch')
    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)
    if cfg.get('cudnn_benchmark', False):
        torch.backends.cudnn.benchmark = True
    if args.work_dir is not None:
        cfg.work_dir = args.work_dir
    elif cfg.get('work_dir', None) is None:
        cfg.work_dir = osp.join('./work_dirs',
                                osp.splitext(osp.basename(args.config))[0])
    if args.load_from is not None:
        cfg.load_from = args.load_from
    if args.resume_from is not None:
        cfg.resume_from = args.resume_from
    cfg.auto_resume = args.auto_resume
    device = train_device(args.device)
    distributed = args.launcher != 'none'
    if distributed:
        device = init_dist(args.launcher, device=device,
                           **cfg.get('dist_params', {}))

    os.makedirs(osp.abspath(cfg.work_dir), exist_ok=True)
    if get_dist_info()[0] == 0:
        cfg.dump(osp.join(cfg.work_dir, osp.basename(args.config)))
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    logger = get_root_logger(log_file=osp.join(cfg.work_dir,
                                               f'{timestamp}.log'),
                             log_level=cfg.get('log_level', 'INFO'))
    env_info = '\n'.join(f'{k}: {v}' for k, v in collect_env().items())
    dash_line = '-' * 60 + '\n'
    logger.info('Environment info:\n' + dash_line + env_info + '\n' +
                dash_line)
    meta = dict(env_info=env_info)
    logger.info(f'Distributed training: {distributed}')
    logger.info(f'Config:\n{cfg.pretty_text}')

    seed = init_random_seed(args.seed)
    logger.info(f'Set random seed to {seed}, '
                f'deterministic: {args.deterministic}')
    set_random_seed(seed, deterministic=args.deterministic)
    cfg.seed = seed
    meta['seed'] = seed
    meta['exp_name'] = osp.basename(args.config)

    model = build_segmentor(cfg.model, train_cfg=cfg.get('train_cfg'),
                            test_cfg=cfg.get('test_cfg'))
    model.init_weights(seed=seed)
    logger.info(model.__class__.__name__)

    if cfg.data.get('img_cache'):
        for split in ('train', 'val'):
            if cfg.data.get(split) is not None:
                inject_img_cache(cfg.data[split], cfg.data['img_cache'],
                                 cfg.data.get('img_cache_dir'))
        logger.info('img_cache: %s decode cache enabled',
                    cfg.data['img_cache'])

    datasets = [build_dataset(cfg.data.train)]
    if len(cfg.workflow) == 2:
        val_dataset = copy.deepcopy(cfg.data.val)
        val_dataset.pipeline = cfg.data.train.pipeline
        datasets.append(build_dataset(val_dataset))
    if cfg.get('checkpoint_config') is not None:
        cfg.checkpoint_config['meta'] = dict(
            stc_unet_tpu_torch_version=stc_unet_tpu_torch.__version__,
            config=cfg.pretty_text, CLASSES=datasets[0].CLASSES,
            PALETTE=datasets[0].PALETTE)
    model.CLASSES = datasets[0].CLASSES
    model.PALETTE = datasets[0].PALETTE
    return train_segmentor(model, datasets, cfg, distributed=distributed,
                           validate=not args.no_validate,
                           timestamp=timestamp, meta=meta, device=device)


if __name__ == '__main__':
    main()
