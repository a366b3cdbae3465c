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
``jax_to_torch_state``. ``load_opt_state`` maps a ``.ckpt``'s optax
``opt_state`` onto a ``torch.optim`` optimizer's state (≙ the JAX
``restore_into``), for resuming a run that the JAX package started.
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
from stc_unet_tpu_torch.core.optimizers import RMSprop
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
    """Read a JAX ``.ckpt`` → dict(meta, variables, step, opt_state?)."""
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
        ckpt['state_dict'] = jax_to_torch_state(ckpt['variables'], model)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    meta = ckpt.get('meta') or {}
    if 'CLASSES' in meta:
        model.CLASSES = tuple(meta['CLASSES'])
    if 'PALETTE' in meta:
        model.PALETTE = meta['PALETTE']
    return ckpt


def _optax_states(opt_state) -> Dict[str, Any]:
    """The states of the JAX package's optax chain
    (``stc_unet_tpu/core/optimizers/builder.py:build_optimizer_tx``), as
    flax serialises a chain: ``{'0': state, '1': ...}``, each state a dict
    of its fields. The chain is: coupled ``add_decayed_weights``, then one
    of ``scale_by_adam`` (``count``, ``mu``, ``nu``), ``trace`` (SGD
    momentum) or ``scale_by_rms`` (``nu``), then decoupled decay and the
    ``paramwise_cfg`` lr masks, then ``scale_by_schedule`` (``count``).
    The decays and masks keep no state (``{}``). Returns the states by
    kind: ``adam``, ``trace``, ``rms``, ``schedule``."""
    kinds = {}
    for key in sorted(opt_state, key=int):
        state = opt_state[key]
        fields = set(state)
        kind = {frozenset(): None,
                frozenset({'count', 'mu', 'nu'}): 'adam',
                frozenset({'trace'}): 'trace',
                frozenset({'nu'}): 'rms',
                frozenset({'count'}): 'schedule'}.get(frozenset(fields), '?')
        if kind == '?' or kind in kinds:
            raise ValueError(f'opt_state entry {key} with fields '
                             f'{sorted(fields)} is not a state of the JAX '
                             f'package\'s optax chain')
        if kind is not None:
            kinds[kind] = state
    return kinds


def load_opt_state(optimizer: torch.optim.Optimizer, model,
                   opt_state) -> None:
    """Set ``optimizer``'s state (an optimizer of ``core.build_optimizer``
    over ``model``'s parameters) from a ``.ckpt``'s ``opt_state``:
    ``mu``/``nu`` → Adam's and AdamW's ``exp_avg``/``exp_avg_sq``,
    ``trace`` → SGD's ``momentum_buffer``, RMSprop's ``nu`` → the port
    ``RMSprop``'s ``nu``, Adam's ``count`` → ``step``. Each moment tree
    goes through ``jax_to_torch_state``, the weights' key translation and
    layout transposes: a moment is elementwise, so the same permutation
    is exact. ``torch.optim``'s ``load_state_dict`` puts the moments on
    their parameters' device and dtype (and ``step`` where torch keeps
    it); a moment left elsewhere raises. The optimizer's kind must match
    the chain's (SGD without momentum keeps no state)."""
    kinds = _optax_states(opt_state)
    params = dict(model.named_parameters())
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        need = 'adam'
    elif isinstance(optimizer, torch.optim.SGD):
        need = 'trace' if any(g['momentum'] for g in
                              optimizer.param_groups) else None
    elif isinstance(optimizer, RMSprop):
        need = 'rms'
    else:
        raise ValueError(f'no opt_state mapping for '
                         f'{type(optimizer).__name__}')
    held = sorted(set(kinds) - {'schedule'})
    if held != ([need] if need else []):
        raise ValueError(f'the checkpoint holds optax states {held}; '
                         f'{type(optimizer).__name__} needs '
                         f'{[need] if need else []}')

    buffers = dict(model.named_buffers())

    def moments(field):
        # the bridge adds the Swin backbone's relative_position_index
        # buffers beside their bias tables: no moment of them
        sd = {k: v for k, v in jax_to_torch_state(
            {'params': kinds[need][field]}, model).items()
            if k not in buffers}
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
        want = {k: tuple(p.shape) for k, p in params.items()}
        if shapes != want:
            off = sorted(k for k in set(shapes) | set(want)
                         if shapes.get(k) != want.get(k))
            raise ValueError(f'opt_state {need}.{field} does not match the '
                             f'model\'s parameters: {off[:4]}')
        return {id(params[k]): v for k, v in sd.items()}

    per_param = {}
    if need == 'adam':
        step = torch.tensor(float(np.asarray(kinds['adam']['count'])),
                            dtype=torch.float32)
        mu, nu = moments('mu'), moments('nu')
        per_param = {i: dict(step=step.clone(), exp_avg=mu[i],
                             exp_avg_sq=nu[i]) for i in mu}
    elif need == 'trace':
        per_param = {i: dict(momentum_buffer=v)
                     for i, v in moments('trace').items()}
    elif need == 'rms':
        per_param = {i: dict(nu=v) for i, v in moments('nu').items()}
    order = [p for g in optimizer.param_groups for p in g['params']]
    state_dict = optimizer.state_dict()
    state_dict['state'] = {n: per_param[id(p)] for n, p in enumerate(order)
                           if id(p) in per_param}
    optimizer.load_state_dict(state_dict)
    for p in order:
        for k, v in optimizer.state[p].items():
            if k != 'step' and torch.is_tensor(v) and v.device != p.device:
                raise RuntimeError(f'optimizer state {k} on {v.device}, its '
                                   f'parameter on {p.device}')


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
    None when there is none. ``suffix='ckpt'`` finds the JAX package's
    as its ``find_latest_checkpoint`` does."""
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
