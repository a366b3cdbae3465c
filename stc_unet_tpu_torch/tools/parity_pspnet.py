"""The stock zoo's trained-accuracy protocol of ``tools/parity_pspnet.py``,
the port's half: PSPNet-R50-D8 (``configs/_base_/models/pspnet_r50-d8.py``:
ResNetV1c-50 at output stride 8, PSPHead, an auxiliary FCNHead on stage
2 weighted 0.4) trained through the port's train CLI and evaluated
through its test CLI.

    python -m stc_unet_tpu_torch.tools.parity_pspnet [--size 256]
        [--epochs 12] [--batch 8] [--train-imgs 32] [--test-imgs 8]
        [--work-dir D] [--device cuda|cpu] [--out F.json]

It writes the learnable pseudo-KiTS fixture of
``tools/parity_trained.py`` (``build_learnable_kits``, the same draws)
at ``--size``² and the JAX tool's config surgery
(``tools/parity_pspnet.py:34-88``): the stock model over
``my_config/_base_kits19.py``'s data, 2 classes, BN for SyncBN, whole
inference, no pretrained weights; the train pipeline a resize to
``--size``², a flip, a normalize and a pad; Adam at lr 3e-4, ``bf16 =
True``, 2 loader threads, no validation. It trains with ``python -m
stc_unet_tpu_torch.tools.train`` and evaluates ``latest.pth`` with
``python -m stc_unet_tpu_torch.tools.test --eval mIoU mDice``, and
prints one JSON record: the port's mIoU and mDice beside the JAX
package's from ``PARITY_PSPNET.json``, the epochs' seconds and images/s,
the train and test CLIs' seconds, and the losses of every step (the
auxiliary head's ``aux.loss_ce`` and ``aux.acc_seg`` among them).
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import time

from stc_unet_tpu_torch.tools.parity_trained import (ParityTrainedRecord,
                                                      build_learnable_kits,
                                                      evaluate_checkpoint)

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
JAX_RECORD = osp.join(REPO, 'PARITY_PSPNET.json')


def write_cfg(path: str, data_root: str, epochs: int, batch: int,
              size: int):
    """The JAX tool's config (``tools/parity_pspnet.py:34-88``), with the
    port's recording hook."""
    base = [osp.join(REPO, 'my_config', '_base_kits19.py'),
            osp.join(REPO, 'configs', '_base_', 'models',
                     'pspnet_r50-d8.py')]
    cfg = f'''
_base_ = {base!r}
norm_cfg = dict(type='BN', requires_grad=True)
train_cfg = None
test_cfg = None
model = dict(
    pretrained=None,
    backbone=dict(norm_cfg=norm_cfg),
    decode_head=dict(num_classes=2, norm_cfg=norm_cfg),
    auxiliary_head=dict(num_classes=2, norm_cfg=norm_cfg),
    test_cfg=dict(mode='whole'))
crop_size = ({size}, {size})
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations'),
    dict(type='Resize', img_scale=({size}, {size}), keep_ratio=False),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True),
    dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_semantic_seg'])
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(
        type='MultiScaleFlipAug',
        img_scale=crop_size,
        flip=False,
        transforms=[
            dict(type='Resize', keep_ratio=False),
            dict(type='Normalize', mean=[0, 0, 0], std=[1, 1, 1],
                 to_rgb=True),
            dict(type='ImageToTensor', keys=['img']),
            dict(type='Collect', keys=['img'])
        ])
]
data = dict(samples_per_gpu={batch}, workers_per_gpu=2,
            train=dict(data_root={data_root!r}, pipeline=train_pipeline),
            val=dict(data_root={data_root!r}, pipeline=test_pipeline),
            test=dict(data_root={data_root!r}, pipeline=test_pipeline))
optimizer = dict(type='Adam', lr=3e-4, betas=(0.9, 0.999))
runner = dict(type='EpochBasedRunner', max_epochs={epochs})
checkpoint_config = dict(by_epoch=True, interval={epochs},
                         save_optimizer=False)
evaluation = dict(interval={epochs + 1}, metric=['mDice'])
log_config = dict(interval=1, hooks=[dict(type='TextLoggerHook')])
custom_hooks = [dict(type='ParityTrainedRecord', priority='HIGHEST')]
bf16 = True
'''
    with open(path, 'w') as f:
        f.write(cfg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--train-imgs', type=int, default=32)
    ap.add_argument('--test-imgs', type=int, default=8)
    ap.add_argument('--epochs', type=int, default=12)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--work-dir', default=osp.join('work_dirs',
                                                   'parity_pspnet'))
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--out', help='write the record here too')
    return ap.parse_args(argv)


def main(argv=None):
    """Run the protocol; returns the record (and prints it)."""
    args = parse_args(argv)
    from stc_unet_tpu_torch.tools import test as test_cli
    from stc_unet_tpu_torch.tools import train as train_cli
    work = osp.abspath(args.work_dir)
    data_root = osp.join(work, 'ds')
    build_learnable_kits(data_root, args.train_imgs, args.test_imgs,
                         args.size)
    cfg_path = osp.join(work, 'cfg.py')
    write_cfg(cfg_path, data_root, args.epochs, args.batch, args.size)
    wd = osp.join(work, 'wd')
    t0 = time.perf_counter()
    train_cli.main([cfg_path, '--work-dir', wd, '--no-validate', '--seed',
                    '0', '--device', args.device])
    train_s = time.perf_counter() - t0
    run = ParityTrainedRecord.runs[-1]
    steps = len(run['logs'])
    checkpoint = osp.join(wd, 'latest.pth')
    record = dict(
        model='pspnet_r50-d8', size=args.size, epochs=args.epochs,
        batch=args.batch, train_imgs=args.train_imgs,
        test_imgs=args.test_imgs, device=args.device, steps=steps,
        train_s=train_s, epoch_s=run['epoch_s'],
        img_per_s=steps * args.batch / sum(run['epoch_s']),
        checkpoint=checkpoint, losses=run['losses'],
        aux_losses=sorted(k for k in run['losses']
                          if k.startswith('aux')),
        **evaluate_checkpoint(test_cli, data_root, cfg_path, checkpoint,
                              osp.join(work, 'metrics'), args.test_imgs,
                              args.device))
    if osp.isfile(JAX_RECORD):
        with open(JAX_RECORD) as f:
            jax_record = json.load(f)
        record['jax'] = dict(jax_record['jax'], size=jax_record['size'],
                             epochs=jax_record['epochs'],
                             batch=jax_record['batch'],
                             source='PARITY_PSPNET.json')
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == '__main__':
    main()
