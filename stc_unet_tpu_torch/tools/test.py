"""Test (and evaluate) a segmentor with the port (≙ ``tools/test.py``, the
same argv):

    python -m stc_unet_tpu_torch.tools.test DATA_ROOT CONFIG CHECKPOINT
        [--eval mIoU mDice ...] [--aug-test] [--out F.pkl] [--format-only]
        [--show-dir D] [--opacity A] [--eval-options K=V ...]
        [--cfg-options K=V ...] [--work-dir D] [--gpu-id N]
        [--device cuda|cpu] [--launcher none|pytorch]

The author's quirks are kept: ``DATA_ROOT`` is the test split's images
directory, and its labels are the same path with ``images`` replaced by
``labels``; ``CONFIG`` is a config file, or a name resolved as
``<work_dirs>/<name>/<name>.py``. ``CHECKPOINT`` is a ``.pth`` or a JAX
``.ckpt``; CLASSES and PALETTE come from its meta, else from the dataset.
``--aug-test`` runs the six ``img_ratios`` 0.5 to 1.75 with flips.
``--eval`` writes ``eval_{single,multi}_scale_<timestamp>.json`` to the
work dir (default ``./work_dirs/<config name>``) and prints the metrics;
``--out`` pickles the results and ``--show-dir`` writes the painted
images. ``--eval cityscapes`` writes the dataset's formatted results
(``format_results``, under ``<work dir>/format_results`` unless
``--eval-options imgfile_prefix=D``) instead of evaluating; so does
``--format-only``, which, as in the JAX CLI, needs ``--eval`` to be
empty, and its default is not. The model runs on the card
(``cuda:<gpu-id>``) unless ``--device cpu`` is given; without CUDA it
raises. ``data.img_cache`` puts the test loader behind the
decoded-image cache. ``--show`` (a window) raises.

``python -m torch.distributed.run --nproc_per_node N -m
stc_unet_tpu_torch.tools.test ... --launcher pytorch`` evaluates the
split's shards on N ranks (``cuda:LOCAL_RANK``, the config's
``dist_params`` as in the train CLI) through ``multi_gpu_test``; rank 0
writes ``--out``, the metrics JSON and the formatted files and prints
the metrics. ``--gpu-collect`` and ``--tmpdir`` are accepted and change
nothing, as in the JAX CLI; ``--show-dir`` with a launcher raises
(``multi_gpu_test`` paints nothing).
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import time
import warnings

import torch

from stc_unet_tpu_torch.apis import multi_gpu_test, single_gpu_test
from stc_unet_tpu_torch.datasets import (build_dataloader, build_dataset,
                                         inject_img_cache)
from stc_unet_tpu_torch.engine import load_checkpoint
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config
from stc_unet_tpu_torch.utils.util_distribution import (get_dist_info,
                                                        init_dist)
from .train import DictAction

AUG_RATIOS = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='test (and evaluate) a segmentor with the port')
    parser.add_argument('--work_dirs', default='work_dirs',
                        help='work_dirs root for config-name resolution')
    parser.add_argument('data_root', help='test data path (images dir)')
    parser.add_argument('config', help='config name or file path')
    parser.add_argument('checkpoint', help='checkpoint file (.pth or .ckpt)')
    parser.add_argument('--work-dir',
                        help='dir to dump evaluation metric json into')
    parser.add_argument('--aug-test', action='store_true',
                        help='use flip and multi-scale TTA')
    parser.add_argument('--out', help='output result file in pickle format')
    parser.add_argument('--format-only', action='store_true',
                        help='format results without evaluation')
    parser.add_argument('--eval', type=str,
                        default=['mIoU', 'mFscore', 'mDice'], nargs='+',
                        help='evaluation metrics, e.g. mIoU mDice')
    parser.add_argument('--show', action='store_true', help='show results')
    parser.add_argument('--show-dir',
                        help='directory to save painted images')
    parser.add_argument('--gpu-collect', action='store_true')
    parser.add_argument('--gpu-id', type=int, default=0)
    parser.add_argument('--tmpdir', help='tmp directory for multi-GPU '
                                         'collection')
    parser.add_argument('--options', nargs='+', action=DictAction,
                        help='(deprecated) use --cfg-options')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='config overrides key=value')
    parser.add_argument('--eval-options', nargs='+', action=DictAction,
                        help='custom options for evaluation')
    parser.add_argument('--launcher',
                        choices=['none', 'pytorch', 'slurm', 'mpi', 'jax'],
                        default='none')
    parser.add_argument('--opacity', type=float, default=0.5)
    parser.add_argument('--local_rank', type=int, default=0)
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='where to run the model (default: the card)')
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    results of ``single_gpu_test`` (``multi_gpu_test`` with a
    launcher)."""
    args = parse_args(argv)
    if not (args.out or args.eval or args.format_only or args.show or
            args.show_dir):
        raise ValueError('Please specify at least one operation (--out/'
                         '--eval/--format-only/--show/--show-dir)')
    if args.eval and args.format_only:
        raise ValueError('--eval and --format_only cannot be both specified')
    distributed = args.launcher != 'none'
    if distributed and args.show_dir:
        raise NotImplementedError(
            '--show-dir with a launcher: multi_gpu_test paints nothing, as '
            'in the JAX CLI; run without a launcher to paint')
    if args.show:
        raise NotImplementedError(
            '--show opens a window, and the port has no window toolkit (the '
            "card's machine has none); use --show-dir")
    device = torch.device('cpu' if args.device == 'cpu'
                          else f'cuda:{args.gpu_id}')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('tools.test: CUDA is not available; pass '
                           '--device cpu to test on the CPU')

    if osp.isfile(args.config):
        cfg_path = args.config
    else:
        cfg_path = osp.join(args.work_dirs, args.config, args.config + '.py')
    cfg = Config.fromfile(cfg_path)
    overrides = args.cfg_options or args.options
    if overrides:
        cfg.merge_from_dict(overrides)
    if args.aug_test:
        cfg.data.test.pipeline[1]['img_ratios'] = list(AUG_RATIOS)
        cfg.data.test.pipeline[1]['flip'] = True
    cfg.model.pretrained = None
    cfg.data.test['test_mode'] = True
    if distributed:
        device = init_dist(args.launcher, device=device.type,
                           **cfg.get('dist_params', {}))
    rank = get_dist_info()[0]

    cfg_name = osp.splitext(osp.basename(cfg_path))[0]
    work_dir = args.work_dir or osp.join('./work_dirs', cfg_name)
    os.makedirs(osp.abspath(work_dir), exist_ok=True)
    timestamp = time.strftime('%Y%m%d_%H%M%S', time.localtime())
    scale_tag = 'multi_scale' if args.aug_test else 'single_scale'
    json_file = osp.join(work_dir, f'eval_{scale_tag}_{timestamp}.json')

    cfg.data.test['data_root'] = args.data_root
    cfg.data.test['img_dir'] = args.data_root
    cfg.data.test['ann_dir'] = args.data_root.replace('images', 'labels')
    if cfg.data.get('img_cache'):
        inject_img_cache(cfg.data.test, cfg.data['img_cache'],
                         cfg.data.get('img_cache_dir'))
    dataset = build_dataset(cfg.data.test)
    data_loader = build_dataloader(
        dataset, samples_per_gpu=1,
        workers_per_gpu=cfg.data.workers_per_gpu, dist=distributed,
        shuffle=False)

    model = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    meta = load_checkpoint(model, args.checkpoint).get('meta') or {}
    if 'CLASSES' in meta:
        model.CLASSES = tuple(meta['CLASSES'])
    else:
        print('"CLASSES" not found in meta, use dataset.CLASSES instead')
        model.CLASSES = dataset.CLASSES
    model.PALETTE = meta['PALETTE'] if 'PALETTE' in meta else \
        dataset.PALETTE
    model.cfg = cfg
    model = model.to(device, memory_format=torch.channels_last).eval()

    eval_kwargs = dict(args.eval_options or {})
    # '--eval cityscapes' evaluates on the formatted files: it formats only
    eval_on_format_results = args.eval is not None and \
        'cityscapes' in args.eval
    if eval_on_format_results and len(args.eval) != 1:
        raise ValueError('eval on format results is not applicable for '
                         'metrics other than cityscapes')
    format_only = args.format_only or eval_on_format_results
    if format_only:
        eval_kwargs.setdefault('imgfile_prefix',
                               osp.join(work_dir, 'format_results'))
    pre_eval = args.eval is not None and not eval_on_format_results
    format_args = eval_kwargs if format_only else {}
    if distributed:
        results = multi_gpu_test(
            model, data_loader, tmpdir=args.tmpdir,
            gpu_collect=args.gpu_collect, pre_eval=pre_eval,
            format_only=format_only, format_args=format_args)
    else:
        results = single_gpu_test(
            model, data_loader, out_dir=args.show_dir, pre_eval=pre_eval,
            format_only=format_only, format_args=format_args,
            opacity=args.opacity)
    if rank != 0:
        return results

    if args.out:
        warnings.warn('--out writes raw outputs to a pickle file')
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.eval and not eval_on_format_results:
        eval_kwargs.pop('imgfile_prefix', None)
        metric = dataset.evaluate(results, metric=args.eval, **eval_kwargs)
        with open(json_file, 'w') as f:
            json.dump(dict(config=cfg_path, metric=metric), f, indent=2,
                      default=str)
        print(json.dumps({k: float(v) for k, v in metric.items()},
                         indent=2))
    return results


if __name__ == '__main__':
    main()
