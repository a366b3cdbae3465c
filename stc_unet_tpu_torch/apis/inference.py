"""Inference API (≙ ``stc_unet_tpu/apis/inference.py``): ``init_segmentor``.

``inference_segmentor`` needs the test pipeline and ``collate``, which
come with a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config


def init_segmentor(config, checkpoint: Optional[str] = None, device=None):
    """Build a segmentor from a config (file name or :class:`Config`).

    Weights come from ``checkpoint`` (a reference ``.pth``: a state_dict,
    or a dict holding one under ``state_dict``, loaded with
    ``strict=True``) or else from ``init_weights(seed=0)``. ``device``
    defaults to ``'cuda'``, and a CUDA device without CUDA raises; pass
    ``device='cpu'`` for the CPU. The model is in eval mode and
    ``channels_last``.
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
        ckpt = torch.load(checkpoint, map_location='cpu', weights_only=False)
        meta = ckpt.get('meta', {}) if 'state_dict' in ckpt else {}
        model.load_state_dict(ckpt.get('state_dict', ckpt), strict=True)
        model.CLASSES = meta.get('CLASSES')
        model.PALETTE = meta.get('PALETTE')
    else:
        model.init_weights()
    model.cfg = config
    return model.to(device, memory_format=torch.channels_last).eval()
