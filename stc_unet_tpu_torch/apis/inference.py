"""Inference API (≙ ``stc_unet_tpu/apis/inference.py``): ``init_segmentor``
and ``inference_segmentor``."""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from stc_unet_tpu_torch.core.evaluation import get_classes
from stc_unet_tpu_torch.datasets import collate
from stc_unet_tpu_torch.datasets.pipelines import Compose
from stc_unet_tpu_torch.engine.checkpoint import load_checkpoint
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config
from .test import _as_test_kwargs


def init_segmentor(config, checkpoint: Optional[str] = None, device=None):
    """Build a segmentor from a config (file name or :class:`Config`).

    Weights come from ``checkpoint`` (a JAX ``.ckpt``, through
    ``jax_to_torch_state``, or a reference ``.pth``: a state_dict, or a
    dict holding one under ``state_dict``; both loaded with
    ``strict=True``) or else from ``init_weights(seed=0)``. CLASSES and
    PALETTE come from the checkpoint's meta; without CLASSES there it
    warns and takes the Cityscapes classes, as the JAX package does.
    ``device`` defaults to ``'cuda'``, and a CUDA device without CUDA
    raises; pass ``device='cpu'`` for the CPU. The model is in eval mode
    and ``channels_last``.
    """
    if isinstance(config, str):
        config = Config.fromfile(config)
    elif not isinstance(config, Config):
        raise TypeError(
            f'config must be a filename or Config object, but got '
            f'{type(config)}')
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('init_segmentor: CUDA is not available; pass '
                           "device='cpu' to run on the CPU")
    config.model.pretrained = None
    config.model.train_cfg = None
    model = build_segmentor(config.model, test_cfg=config.get('test_cfg'))
    if checkpoint is not None:
        meta = load_checkpoint(model, checkpoint).get('meta') or {}
        if 'CLASSES' not in meta:
            warnings.warn('CLASSES is not saved in the checkpoint meta')
            model.CLASSES = get_classes('cityscapes')
    else:
        model.init_weights()
    model.cfg = config
    return model.to(device, memory_format=torch.channels_last).eval()


def inference_segmentor(model, imgs):
    """Label maps of image paths or BGR arrays (one, or a list): the
    config's test pipeline with its first step replaced by ``LoadImage``,
    ``collate``, then the model on its device. Returns a list of (H, W)
    numpy label maps, one an image."""
    test_pipeline = [dict(type='LoadImage')] + [
        dict(t) for t in model.cfg.data.test.pipeline[1:]]
    pipeline = Compose(test_pipeline)
    if not isinstance(imgs, (list, tuple)):
        imgs = [imgs]
    data = collate([pipeline(dict(img=img)) for img in imgs])
    return model(return_loss=False, rescale=True, **_as_test_kwargs(data))
