"""Checkpoints (≙ ``stc_unet_tpu/engine/checkpoint.py``): saving the
port's ``.pth``, and loading a ``.pth`` or a JAX ``.ckpt``.

The port writes ``.pth`` files in the reference fork's (mmcv's) layout:
``{'meta': {..., 'epoch', 'iter', 'CLASSES', 'PALETTE'}, 'state_dict':
the model's state_dict on the CPU, under the fork's keys, 'optimizer': the
torch.optim state_dict}``, the last with ``save_optimizer`` only.

A JAX ``.ckpt`` is one msgpack map ``{'meta': json str, 'variables':
bytes, 'step': int, 'opt_state': bytes?}``, where ``variables`` and
``opt_state`` are themselves ``flax.serialization.msgpack_serialize``d
trees. flax writes an array as ext 1 holding msgpack ``(shape, dtype name,
C-order bytes)``, a numpy scalar as ext 3 in the same form, and a complex
number as ext 2 holding ``(real, imag)``. The port decodes all of it with
its own msgpack reader (``utils/msgpack_decode.py``), without flax:
arrays come back as numpy arrays, except ``bfloat16`` ones, which numpy
lacks: their bytes are viewed as int16 and then as ``torch.bfloat16``.
flax splits a leaf over 1 GiB into chunks; such a file is refused.

``load_checkpoint`` takes a ``.ckpt`` or a fork ``.pth`` (told apart by
the first bytes: torch's files are zip archives, or pickles in torch's
legacy format) and loads the weights into a port model with
``strict=True``, the ``.ckpt``'s variables through
``jax_to_torch_state``.
"""
from __future__ import annotations

import glob
import json
import os
import os.path as osp
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import stc_unet_tpu_torch
from stc_unet_tpu_torch.utils import jax_to_torch_state
from stc_unet_tpu_torch.utils.msgpack_decode import ExtType, unpackb

_TORCH_MAGIC = (b'PK\x03\x04', b'\x80\x02')   # zip archive, legacy pickle
_CHUNKED = '__msgpack_chunked_array__'


def _ndarray(data: bytes):
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if dtype_name == b'bfloat16':
        flat = torch.from_numpy(np.frombuffer(buffer, np.int16).copy())
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _refuse_chunked(tree, path='') -> None:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                f'checkpoint leaf {path or "<root>"} was split by flax into '
                f'chunks (an array over 1 GiB); chunked leaves are not '
                f'supported')
        for k, v in tree.items():
            _refuse_chunked(v, f'{path}/{k}')


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore`` without flax: the tree with
    array leaves (numpy, or torch for bfloat16)."""
    tree = unpackb(data, ext_hook=_flax_ext)
    _refuse_chunked(tree)
    return tree


def load_checkpoint_file(filename: str) -> Dict[str, Any]:
    """Read a JAX ``.ckpt`` → dict(meta, variables, step, opt_state?).
    ``opt_state`` is decoded and returned; nothing in the port uses it
    (resuming from a ``.ckpt`` is ROADMAP.md §1, Item 13b)."""
    with open(filename, 'rb') as f:
        payload = unpackb(f.read())
    if not isinstance(payload, dict) or 'variables' not in payload:
        raise ValueError(f'{filename}: not a checkpoint of the JAX package '
                         f'(no variables)')
    out = {
        'meta': json.loads(payload['meta']) if payload.get('meta') else {},
        'variables': msgpack_restore(payload['variables']),
        'step': int(payload.get('step', 0)),
    }
    if 'opt_state' in payload:
        out['opt_state'] = msgpack_restore(payload['opt_state'])
    return out


def is_torch_file(filename: str) -> bool:
    """Whether ``filename`` is a file of ``torch.save`` (else a ``.ckpt``)."""
    with open(filename, 'rb') as f:
        head = f.read(4)
    return any(head.startswith(m) for m in _TORCH_MAGIC)


def load_checkpoint(model, filename: str) -> Dict[str, Any]:
    """Load a ``.ckpt`` or ``.pth`` into ``model`` with ``strict=True``
    and return the checkpoint: a ``.ckpt`` as ``load_checkpoint_file``
    gives it, with ``state_dict`` added; a ``.pth`` as ``torch.load`` gives
    it (a state_dict, or a dict holding one under ``state_dict``). The
    meta's CLASSES and PALETTE are set on the model where it has them."""
    if is_torch_file(filename):
        ckpt = torch.load(filename, map_location='cpu', weights_only=False)
        if 'state_dict' not in ckpt:
            ckpt = dict(state_dict=ckpt)
    else:
        ckpt = load_checkpoint_file(filename)
        ckpt['state_dict'] = jax_to_torch_state(ckpt['variables'])
    model.load_state_dict(ckpt['state_dict'], strict=True)
    meta = ckpt.get('meta') or {}
    if 'CLASSES' in meta:
        model.CLASSES = tuple(meta['CLASSES'])
    if 'PALETTE' in meta:
        model.PALETTE = meta['PALETTE']
    return ckpt


def save_checkpoint(model, filename: str, optimizer=None,
                    meta: Optional[dict] = None) -> str:
    """Write ``model`` (and ``optimizer``'s state, if given) to
    ``filename`` in the fork's ``.pth`` layout, through a temporary file
    and a rename. ``meta`` gets the time and the port's version; the
    model's CLASSES and PALETTE where it has them and ``meta`` does not."""
    meta = dict(meta or {})
    meta.setdefault('time', time.asctime())
    meta.setdefault('stc_unet_tpu_torch_version',
                    stc_unet_tpu_torch.__version__)
    for key in ('CLASSES', 'PALETTE'):
        value = getattr(model, key, None)
        if value is not None:
            meta.setdefault(key, value)
    checkpoint = {
        'meta': meta,
        'state_dict': {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}}
    if optimizer is not None:
        checkpoint['optimizer'] = optimizer.state_dict()
    os.makedirs(osp.dirname(osp.abspath(filename)), exist_ok=True)
    tmp = f'{filename}.tmp'
    torch.save(checkpoint, tmp)
    os.replace(tmp, filename)
    return filename


def find_latest_checkpoint(path: str, suffix: str = 'pth') -> Optional[str]:
    """The newest checkpoint in ``path``: ``latest.{suffix}`` if there is
    one, else the ``*.{suffix}`` with the largest number in its name;
    None when there is none."""
    if not osp.isdir(path):
        return None
    latest = osp.join(path, f'latest.{suffix}')
    if osp.exists(latest):
        return latest
    best, best_step = None, -1
    for ckpt in glob.glob(osp.join(path, f'*.{suffix}')):
        digits = ''.join(c for c in osp.basename(ckpt) if c.isdigit())
        step = int(digits) if digits else 0
        if step > best_step:
            best, best_step = ckpt, step
    return best
