"""JAX variables → the port's ``state_dict`` (the weight bridge).

The inverse of ``stc_unet_tpu/utils/torch_convert.py`` (``translate_key`` +
``_transform``), written against the flax variable paths so it needs
neither jax nor the JAX package: the caller hands in the
``{'params', 'batch_stats'}`` trees as nested dicts of numpy arrays.

- conv ``kernel`` HWIO → ``weight`` OIHW;
- linear ``kernel`` (in, out) → ``weight`` (out, in), under a ``linear``
  brick or a bare ``nn.Dense`` (``.../qkv_mapping/kernel``);
- a bare ``nn.ConvTranspose`` ``kernel`` (kh, kw, in, out) → ``weight``
  (in, out, kh, kw) flipped in both spatial axes. flax's ``ConvTranspose``
  (``transpose_kernel=False``) does not flip its kernel, and torch's
  ``ConvTranspose2d``, the adjoint of a cross-correlation, does; without
  the flip every shape matches and the output is wrong;
- BN and LayerNorm ``scale`` → ``weight``; ``mean``/``var`` →
  ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``,
  so the result loads with ``strict=True``);
- the packed ``in_proj_weight``/``in_proj_bias`` of the MHA and the
  ``relative_position_bias_table`` kept verbatim;
- flax names that stand for a sequence index (``stem_0``, ``stages_1``,
  ``blocks_0``) become that index (``stem.0``, ``stages.1``, ``blocks.0``).

The STC-UNet keys are the reference fork's
(``backbone.inc.conv.conv.0.weight``, ``decode_head.up1.ca.conv1.weight``,
...), i.e. the layout of the port's modules and of the fork's ``.pth``
checkpoints. The MaxViT-UNet keys follow the flax names
(``backbone.stages.0.blocks.0.block_transformer.attention.qkv_mapping.
weight``): the fork's MaxViT module layout is not in the repo.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_DC = {'conv0': '0', 'bn1': '1', 'conv3': '3', 'bn4': '4'}
_DC_ALT = '|'.join(_DC)

# flax module path (dotted) → torch module path; applied in order
_RULES = (
    (re.compile(rf'\binc\.({_DC_ALT})\b'),
     lambda m: f'inc.conv.conv.{_DC[m.group(1)]}'),
    (re.compile(rf'\b(down\d)\.conv\.({_DC_ALT})\b'),
     lambda m: f'{m.group(1)}.down_conv.1.conv.{_DC[m.group(2)]}'),
    (re.compile(rf'\b(up\d)\.conv\.({_DC_ALT})\b'),
     lambda m: f'{m.group(1)}.conv.conv.{_DC[m.group(2)]}'),
    (re.compile(r'\b(context_layer\d_\d)\.conv(\d)\b'),
     lambda m: f'{m.group(1)}.convs.{m.group(2)}.0'),
    (re.compile(r'\b(context_layer\d_\d)\.bn(\d)\b'),
     lambda m: f'{m.group(1)}.convs.{m.group(2)}.1'),
    (re.compile(r'\bfcs(\d)\b'), lambda m: f'fcs.{m.group(1)}'),
    (re.compile(r'\btr(\d)\b'), lambda m: f'tr.{m.group(1)}'),
    (re.compile(r'\b(stem|stages|blocks)_(\d+)\b'),
     lambda m: f'{m.group(1)}.{m.group(2)}'),
)


def translate_path(path: Tuple[str, ...], collection: str = 'params'):
    """One flax leaf path → (torch key, transform tag).

    Tags: ``conv_w`` (HWIO→OIHW), ``linear_w`` ((in,out)→(out,in)),
    ``kernel`` (a bare flax kernel: a Dense's when 2-D, a ConvTranspose's
    when 4-D), ``verbatim``.
    """
    leaf = path[-1]
    tag = 'verbatim'
    if leaf in ('kernel', 'bias') and len(path) > 1 and \
            path[-2] in ('conv', 'linear'):
        # the Conv2d/Linear bricks wrap flax's layer under this name
        if leaf == 'kernel':
            tag = 'conv_w' if path[-2] == 'conv' else 'linear_w'
        module = path[:-2]
        name = 'weight' if leaf == 'kernel' else 'bias'
    elif collection == 'batch_stats':
        module = path[:-1]
        name = {'mean': 'running_mean', 'var': 'running_var'}[leaf]
    elif leaf == 'kernel':
        module, name, tag = path[:-1], 'weight', 'kernel'
    elif leaf == 'scale':
        module, name = path[:-1], 'weight'
    elif leaf in ('bias', 'in_proj_weight', 'in_proj_bias',
                  'relative_position_bias_table'):
        module, name = path[:-1], leaf
    else:
        raise KeyError(f'cannot translate flax path {"/".join(path)}')
    key = '.'.join(module)
    for pattern, repl in _RULES:
        key = pattern.sub(repl, key)
    return f'{key}.{name}', tag


def _transform(value: np.ndarray, tag: str) -> np.ndarray:
    if tag == 'conv_w':
        return np.transpose(value, (3, 2, 0, 1))
    if tag == 'linear_w' or (tag == 'kernel' and value.ndim == 2):
        return np.transpose(value, (1, 0))
    if tag == 'kernel' and value.ndim == 4:
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if tag == 'kernel':
        raise ValueError(f'a bare flax kernel of shape {value.shape}')
    return value


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_to_torch_state(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` (numpy leaves) → state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(collection, {})):
            key, tag = translate_path(path, collection)
            v = _transform(np.array(value, np.float32), tag)
            sd[key] = torch.from_numpy(np.ascontiguousarray(v))
            if key.endswith('.running_mean'):
                sd[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
    return sd
