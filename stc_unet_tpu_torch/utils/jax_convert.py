"""JAX variables → the port's ``state_dict`` (the weight bridge).

The inverse of ``stc_unet_tpu/utils/torch_convert.py`` (``translate_key`` +
``_transform``), written against the flax variable paths so it needs
neither jax nor the JAX package: the caller hands in the
``{'params', 'batch_stats'}`` trees as nested dicts of numpy arrays.

- conv ``kernel`` HWIO → ``weight`` OIHW; under a ``ConvTranspose2d``
  brick (``.../conv/kernel`` too: ResUNet's ``up1``, LinkNet's
  ``tp_conv``, MultiResUnet's ``upsample6``) the port module it lands in
  decides, as for a bare kernel below: a ``ConvTranspose2d`` takes the
  flipped (in, out, kh, kw);
- linear ``kernel`` (in, out) → ``weight`` (out, in), under a ``linear``
  brick or a bare ``nn.Dense`` (``.../qkv_mapping/kernel``);
- a bare 4-D flax ``kernel`` (an ``nn.Conv`` or ``nn.ConvTranspose``
  outside the bricks) by the type of the port module it lands in, so the
  model must be given for a tree that holds one: a ``ConvTranspose2d``
  (MaxViT's ``DeconvModule``, DC-UNet's ``Deconv2x``) takes (kh, kw, in,
  out) as ``weight`` (in, out, kh, kw) flipped in both spatial axes, and
  a ``Conv2d`` (SwinUNet's ``patch_embed.proj`` and ``output``) takes
  HWIO as OIHW, not flipped. flax's ``ConvTranspose``
  (``transpose_kernel=False``) does not flip its kernel, and torch's
  ``ConvTranspose2d``, the adjoint of a cross-correlation, does; the two
  transforms give tensors of the same shapes, so a wrong one shows only
  in the output;
- BN and LayerNorm ``scale`` → ``weight``; ``mean``/``var`` →
  ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``,
  so the result loads with ``strict=True``);
- the packed ``in_proj_weight``/``in_proj_bias`` of the MHA, the
  ``relative_position_bias_table``, ViT's ``cls_token`` and
  ``embedding`` and a PReLU's ``weight`` kept verbatim;
- flax names that stand for a sequence index (``stem_0``, ``stages_1``,
  ``blocks_0``, ``layers_0``, ``layers_up_1``, ``layer_blocks_2``) become
  that index (``stem.0``, ``stages.1``, ``blocks.0``, ``layers.0``,
  ``layers_up.1``, ``layer_blocks.2``).

The STC-UNet keys are the reference fork's
(``backbone.inc.conv.conv.0.weight``, ``decode_head.up1.ca.conv1.weight``,
...), i.e. the layout of the port's modules and of the fork's ``.pth``
checkpoints. The MaxViT-UNet keys follow the flax names
(``backbone.stages.0.blocks.0.block_transformer.attention.qkv_mapping.
weight``): the fork's MaxViT module layout is not in the repo. So do
those of the ``EncoderDecoderFull`` heads (DC-UNet, UNet++, TransUNet,
SwinUNet: ``decode_head.mres_block1.conv3x3.0.weight``,
``decode_head.swin_unet.layers.0.blocks.1.attn.qkv.weight``), for the same
reason. The ResNet models (PSPNet, DeepLabv3+) take mmseg's keys: a
``ConvModule``'s ``conv_m`` is its ``conv``
(``decode_head.bottleneck.conv.weight``), the deep stem's ``stem_conv{j}``
and ``stem_bn{j}`` are ``stem.{3j}`` and ``stem.{3j+1}``, a PPM scale's
ConvModule is ``psp_modules.{i}.1`` (behind its pool), the image-pool
ConvModule ``image_pool.1``, ``sep_bottleneck_{i}`` is
``sep_bottleneck.{i}``, and under ``avg_down`` a shortcut's conv and BN
are ``downsample.1`` and ``.2`` (behind its pool: the model must be given
to tell).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

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
    (re.compile(r'\b(stem|stages|blocks|layers|layers_up|layer_blocks)'
                r'_(\d+)\b'),
     lambda m: f'{m.group(1)}.{m.group(2)}'),
    # the ResNet models (mmseg's layout)
    (re.compile(r'\bconv_m\b'), lambda m: 'conv'),
    (re.compile(r'\bstem_conv(\d)\b'),
     lambda m: f'stem.{3 * int(m.group(1))}'),
    (re.compile(r'\bstem_bn(\d)\b'),
     lambda m: f'stem.{3 * int(m.group(1)) + 1}'),
    (re.compile(r'\bpsp_modules\.(\d+)\b'),
     lambda m: f'psp_modules.{m.group(1)}.1'),
    (re.compile(r'\bimage_pool_conv\b'), lambda m: 'image_pool.1'),
    (re.compile(r'\bsep_bottleneck_(\d+)\b'),
     lambda m: f'sep_bottleneck.{m.group(1)}'),
)
# a ResNet shortcut's conv and BN (flax ``downsample/0``, ``/1``)
_DOWNSAMPLE = re.compile(r'^(.*\.downsample)\.(\d)\.(\w+)$')


def translate_path(path: Tuple[str, ...], collection: str = 'params'):
    """One flax leaf path → (torch key, transform tag).

    Tags: ``conv_w`` (HWIO→OIHW), ``linear_w`` ((in,out)→(out,in)),
    ``kernel`` (a bare flax kernel: a Dense's when 2-D, a Conv's or a
    ConvTranspose's when 4-D), ``verbatim``.
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
    elif leaf in ('bias', 'weight', 'in_proj_weight', 'in_proj_bias',
                  'relative_position_bias_table', 'cls_token', 'embedding'):
        module, name = path[:-1], leaf
    else:
        raise KeyError(f'cannot translate flax path {"/".join(path)}')
    key = '.'.join(module)
    for pattern, repl in _RULES:
        key = pattern.sub(repl, key)
    return (f'{key}.{name}' if key else name), tag


def _bare_4d_tag(key: str, modules: Dict[str, nn.Module]) -> str:
    """``deconv_w`` or ``conv_w`` for a bare 4-D kernel landing at
    ``key``, by the type of its module in ``modules``."""
    module = modules.get(key.rpartition('.')[0])
    if isinstance(module, nn.ConvTranspose2d):
        return 'deconv_w'
    if isinstance(module, nn.Conv2d):
        return 'conv_w'
    raise ValueError(
        f'{key}: a bare 4-D flax kernel is a Conv\'s or a ConvTranspose\'s '
        f'of the same shape; pass the model to tell them apart'
        if module is None else
        f'{key}: a bare 4-D flax kernel for a {type(module).__name__}')


def _brick_conv_tag(key: str, modules: Dict[str, nn.Module]) -> str:
    """``deconv_w`` for a conv brick's kernel landing at ``key`` on a
    ``ConvTranspose2d`` of the model, else ``conv_w``. Without the model
    every brick kernel is a conv's: a tree with a brick ``ConvTranspose2d``
    needs the model."""
    module = modules.get(key.rpartition('.')[0])
    return 'deconv_w' if isinstance(module, nn.ConvTranspose2d) else 'conv_w'


def _behind_pool(key: str, modules: Dict[str, nn.Module]) -> str:
    """``key`` one index further in a ResNet shortcut whose first module
    is an average pool (``avg_down``: mmseg's ``downsample.1`` is the conv,
    ``.2`` the BN); the model tells, so a V1d tree needs it."""
    m = _DOWNSAMPLE.match(key)
    if m is None or not isinstance(modules.get(f'{m.group(1)}.0'),
                                   nn.AvgPool2d):
        return key
    return f'{m.group(1)}.{int(m.group(2)) + 1}.{m.group(3)}'


def _transform(value: np.ndarray, tag: str) -> np.ndarray:
    if tag == 'conv_w':
        return np.transpose(value, (3, 2, 0, 1))
    if tag == 'deconv_w':
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if tag == 'linear_w' or (tag == 'kernel' and value.ndim == 2):
        return np.transpose(value, (1, 0))
    if tag == 'kernel':
        raise ValueError(f'a bare flax kernel of shape {value.shape}')
    return value


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _float32(value) -> np.ndarray:
    if torch.is_tensor(value):     # a bfloat16 leaf of a .ckpt
        return value.float().numpy()
    return np.array(value, np.float32)


def jax_to_torch_state(variables: Dict[str, Any],
                       model: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` (numpy leaves, or torch tensors
    for bfloat16) → state_dict, in float32. ``model``, the port module the
    result is for, decides how a bare 4-D kernel turns (without it such a
    kernel raises), whether a conv brick's kernel is a transposed conv's
    (without it, never) and whether a ResNet shortcut sits behind a
    pool."""
    modules = dict(model.named_modules()) if model is not None else {}
    sd: Dict[str, torch.Tensor] = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(collection, {})):
            key, tag = translate_path(path, collection)
            v = _float32(value)
            if tag == 'kernel' and v.ndim == 4:
                tag = _bare_4d_tag(key, modules)
            elif tag == 'conv_w':
                tag = _brick_conv_tag(key, modules)
            key = _behind_pool(key, modules)
            v = _transform(v, tag)
            sd[key] = torch.from_numpy(np.ascontiguousarray(v))
            if key.endswith('.running_mean'):
                sd[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
    return sd
