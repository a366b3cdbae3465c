"""The input path's timing through the port's train CLI (≙
``tools/profile_input.py``): ``data_time`` and the iteration's time under
five input configurations.

    python -m stc_unet_tpu_torch.tools.profile_input [--epochs 6]
        [--batch 8] [--size 512] [--train-imgs 32] [--log-interval 1]
        [--configs host,device,...] [--work-dir D] [--device cuda|cpu]
        [--out F.json]

It writes the learnable pseudo-KiTS fixture of
``tools.parity_trained`` and trains full-width ``my_config/STC-UNet.py``
(Adam lr 3e-4, bf16, 2 loader threads, no validation, no checkpoint)
with ``python -m stc_unet_tpu_torch.tools.train`` once for each entry of
``CONFIGS``: the host pipeline or the augmentation on the device
(``data.device_pipeline``), without or with the decoded-image cache
(``data.img_cache``, on disk or in RAM), all in one process. For each
it reports ``data_time_<tag>_s`` (the wait for the next batch, the
``IterTimerHook``'s) and ``step_time_<tag>_s`` (the whole iteration),
means over the later iterations of the run's JSON log (from the larger
of 2 and a quarter of them on), and ``img_per_s_<tag>``, the batch over
the iteration. ``data_time`` depends on how far the loader's threads
overlap the step, so only runs on the card say what a user gets.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp

from stc_unet_tpu_torch.tools.parity_trained import (CONFIG,
                                                     build_learnable_kits,
                                                     mean_log_value)

CONFIGS = [
    # (tag, device_pipeline, img_cache)
    ('host', False, None),
    ('host_diskcache', False, 'disk'),
    ('device', True, None),
    ('device_diskcache', True, 'disk'),
    ('device_ramcache', True, 'ram'),
]


def write_cfg(path, data_root, epochs, batch, device_pipeline, img_cache,
              cache_dir, log_interval=1):
    extra = f'img_cache={img_cache!r}, img_cache_dir={cache_dir!r},' \
        if img_cache else ''
    cfg = f'''
_base_ = [{CONFIG!r}]
data = dict(samples_per_gpu={batch}, workers_per_gpu=2,
            device_pipeline={device_pipeline}, {extra}
            train=dict(data_root={data_root!r}),
            val=dict(data_root={data_root!r}),
            test=dict(data_root={data_root!r}))
optimizer = dict(type='Adam', lr=3e-4, betas=(0.9, 0.999))
runner = dict(type='EpochBasedRunner', max_epochs={epochs})
checkpoint_config = dict(by_epoch=True, interval={epochs + 1},
                         save_optimizer=False)
evaluation = dict(interval={epochs + 1}, metric=['mDice'])
log_config = dict(interval={log_interval},
                  hooks=[dict(type='TextLoggerHook')])
bf16 = True
'''
    with open(path, 'w') as f:
        f.write(cfg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--train-imgs', type=int, default=32)
    ap.add_argument('--epochs', type=int, default=6)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--log-interval', type=int, default=1,
                    help="TextLoggerHook's interval; 1 reads the losses "
                         'back every step')
    ap.add_argument('--configs', default='',
                    help='comma-separated tags of CONFIGS (default: all)')
    ap.add_argument('--work-dir', default=osp.join('work_dirs',
                                                   'profile_input'))
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--out', help='write the record here too')
    return ap.parse_args(argv)


def main(argv=None):
    """Train under each configuration; returns the record (and prints
    it)."""
    args = parse_args(argv)
    from stc_unet_tpu_torch.tools import train as train_cli
    work = osp.abspath(args.work_dir)
    data_root = osp.join(work, 'ds')
    build_learnable_kits(data_root, args.train_imgs, 2, args.size)
    result = dict(size=args.size, batch=args.batch, epochs=args.epochs,
                  train_imgs=args.train_imgs, device=args.device,
                  log_interval=args.log_interval)
    only = [t for t in args.configs.split(',') if t]
    for tag, device_pipeline, cache in CONFIGS:
        if only and tag not in only:
            continue
        cfg_path = osp.join(work, f'cfg_{tag}.py')
        wd = osp.join(work, f'wd_{tag}')
        write_cfg(cfg_path, data_root, args.epochs, args.batch,
                  device_pipeline, cache, osp.join(work, f'cache_{tag}'),
                  log_interval=args.log_interval)
        runner = train_cli.main([cfg_path, '--work-dir', wd, '--no-validate',
                                 '--seed', '0', '--device', args.device])
        result[f'loader_{tag}'] = type(runner.data_loader).__name__
        del runner
        result[f'data_time_{tag}_s'] = mean_log_value(wd, 'data_time')
        result[f'step_time_{tag}_s'] = mean_log_value(wd, 'time')
        result[f'img_per_s_{tag}'] = \
            args.batch / result[f'step_time_{tag}_s']
        print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    main()
