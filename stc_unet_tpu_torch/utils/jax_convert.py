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
  ``relative_position_bias_table``, the ViTs' ``cls_token``,
  ``embedding`` and ``pos_embed``, the Segmenter head's ``cls_emb`` and a
  PReLU's ``weight`` kept verbatim;
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
to tell); mmseg's ``ConvModule`` lists (``convs_{i}``,
``lateral_convs_{i}``, ``fpn_convs_{i}``) become ``convs.{i}``,
``lateral_convs.{i}``, ``fpn_convs.{i}``. The Swin backbone takes the
fork's (mmseg v0.29.1) keys: ``patch_embed.proj`` is
``patch_embed.projection``, a block's ``attn`` is ``attn.w_msa``, its
``mlp.fc1`` and ``mlp.fc2`` are ``ffn.layers.0.0`` and ``ffn.layers.1``,
the fork's ``relative_position_index`` buffer is added beside each bias
table, and the 4C axis of a ``PatchMerging``'s norm and reduction is
permuted from the JAX concatenation (x00, x10, x01, x11, channel-minor)
to the fork's ``nn.Unfold`` order (channel-major; :func:`merge_order`).
The auxiliary heads (flax ``auxiliary_head_{i}``) are
``auxiliary_head`` for one head and ``auxiliary_head.{i}`` for a list,
as the model given holds them (one head without a model). The necks,
``FPNHead`` and the ViT backbone take mmseg's keys where the model has
them: JPU's ``conv_{i}`` and ``dilation_{i}`` are ``conv_layers.{i}.0``
and ``dilation_layers.{i}.0``, FPN's ``extra_convs_{i}`` is
``fpn_convs.{n + i}`` (n the levels it uses), ``FPNHead``'s
``scale_heads_{i}_{k}`` is ``scale_heads.{i}.{2k}`` on a level whose
``nn.Sequential`` interleaves upsamples (``.{k}`` on the first),
MLANeck's ``norm_{i}``, ``mla_convs1_{i}`` and ``mla_convs2_{i}`` are
``norm.{i}``, ``mla.channel_proj.{i}`` and ``mla.feat_extract.{i}``,
Feature2Pyramid's ``up4_deconv1_{i}``, ``up4_bn_{i}``,
``up4_deconv2_{i}`` and ``up2_deconv_{i}`` (bare transposed-conv
kernels: flipped) are ``upsample_4x.{0,1,3}`` and ``upsample_2x.0``;
the ViT's ``patch_embed`` is ``patch_embed.projection``, a layer's
``norm1``/``norm2`` are ``ln1``/``ln2``, its ``attn.qkv`` (transposed) is
``attn.attn.in_proj_weight`` and ``in_proj_bias``, ``attn.proj`` is
``attn.attn.out_proj``, ``fc1``/``fc2`` are ``ffn.layers.0.0`` and
``ffn.layers.1``, and ``norm1_final`` is ``ln1``. So do the ViT's heads:
SETR's ``up_convs_{i}`` and ``up_convs_{i}_{j}`` are ``up_convs.{i}.0``
and ``up_convs.{i}.{j}`` (each level an ``nn.Sequential`` ending in its
upsample), the Segmenter head's ``layers_{i}`` take the ViT's names and
its ``cls_emb`` is kept verbatim, DPT's ``reassemble_blocks``
``projects_{i}`` (a 1x1 conv brick) is ``projects.{i}.conv``,
``readout_projects_{i}`` the Linear ``readout_projects.{i}.0`` before its
GELU, ``resize_layers_{i}`` (bare transposed-conv kernels for 0 and 1:
flipped) and ``fusion_blocks_{i}`` are ``resize_layers.{i}`` and
``fusion_blocks.{i}``.
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
    (re.compile(r'\b(convs|lateral_convs|fpn_convs|auxiliary_head)_(\d+)'
                r'\b'),
     lambda m: f'{m.group(1)}.{m.group(2)}'),
)
# the fork's (mmseg's) names in the Swin backbone, the necks and the ViT
# backbone, taken where the model has the renamed module (SwinUNet has
# none of them: it keeps the flax names): (pattern, replacement, prefix of
# the parameter name)
_FORK_NAMES = (
    (re.compile(r'\bpatch_embed\.proj$'), 'patch_embed.projection', ''),
    (re.compile(r'\b(blocks\.\d+)\.attn\b'), r'\1.attn.w_msa', ''),
    (re.compile(r'\b(blocks\.\d+)\.mlp\.fc1$'), r'\1.ffn.layers.0.0', ''),
    (re.compile(r'\b(blocks\.\d+)\.mlp\.fc2$'), r'\1.ffn.layers.1', ''),
    (re.compile(r'(^|\.)conv_(\d+)\b'), r'\1conv_layers.\2.0', ''),
    (re.compile(r'(^|\.)dilation_(\d+)\b'), r'\1dilation_layers.\2.0', ''),
    (re.compile(r'(^|\.)norm_(\d+)$'), r'\1norm.\2', ''),
    (re.compile(r'(^|\.)mla_convs1_(\d+)\b'), r'\1mla.channel_proj.\2', ''),
    (re.compile(r'(^|\.)mla_convs2_(\d+)\b'), r'\1mla.feat_extract.\2', ''),
    (re.compile(r'(^|\.)up4_deconv1_\d+$'), r'\1upsample_4x.0', ''),
    (re.compile(r'(^|\.)up4_bn_\d+$'), r'\1upsample_4x.1', ''),
    (re.compile(r'(^|\.)up4_deconv2_\d+$'), r'\1upsample_4x.3', ''),
    (re.compile(r'(^|\.)up2_deconv_\d+$'), r'\1upsample_2x.0', ''),
    (re.compile(r'(^|\.)patch_embed$'), r'\1patch_embed.projection', ''),
    (re.compile(r'\b(layers\.\d+)\.norm([12])$'), r'\1.ln\2', ''),
    (re.compile(r'\b(layers\.\d+)\.fc1$'), r'\1.ffn.layers.0.0', ''),
    (re.compile(r'\b(layers\.\d+)\.fc2$'), r'\1.ffn.layers.1', ''),
    (re.compile(r'\b(layers\.\d+\.attn)\.proj$'), r'\1.attn.out_proj', ''),
    (re.compile(r'\b(layers\.\d+\.attn)\.qkv$'), r'\1.attn', 'in_proj_'),
    (re.compile(r'(^|\.)norm1_final$'), r'\1ln1', ''),
    (re.compile(r'(^|\.)up_convs_(\d+)_(\d+)\b'), r'\1up_convs.\2.\3', ''),
    (re.compile(r'(^|\.)up_convs_(\d+)\b'), r'\1up_convs.\2.0', ''),
    (re.compile(r'(^|\.)projects_(\d+)$'), r'\1projects.\2.conv', ''),
    (re.compile(r'(^|\.)readout_projects_(\d+)$'),
     r'\1readout_projects.\2.0', ''),
    (re.compile(r'(^|\.)(resize_layers|fusion_blocks)_(\d+)\b'),
     r'\1\2.\3', ''),
)
_EXTRA_CONV = re.compile(r'^((?:.*\.)?)extra_convs_(\d+)\b')
_SCALE_HEAD = re.compile(r'^((?:.*\.)?)scale_heads_(\d+)_(\d+)\b')
# a ResNet shortcut's conv and BN (flax ``downsample/0``, ``/1``)
_DOWNSAMPLE = re.compile(r'^(.*\.downsample)\.(\d)\.(\w+)$')
_BIAS_TABLE = '.attn.w_msa.relative_position_bias_table'


def merge_order(width: int) -> np.ndarray:
    """The JAX index of each position of a merged Swin token's ``width``
    (4C) axis in the fork's order: the fork's 4c + p (p the 2×2
    position in ``nn.Unfold``'s order x00, x01, x10, x11) holds the JAX
    q·C + c (q in the official order x00, x10, x01, x11)."""
    c = width // 4
    q = np.array([0, 2, 1, 3])          # the fork's p as the JAX q
    return (q[None, :] * c + np.arange(c)[:, None]).reshape(-1)


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
                  'relative_position_bias_table', 'cls_token', 'embedding',
                  'pos_embed', 'cls_emb'):
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


def _mmseg_index(module: str, modules: Dict[str, nn.Module]) -> str:
    """``module`` with FPN's ``extra_convs_{i}`` at
    ``fpn_convs.{n + i}`` and ``FPNHead``'s ``scale_heads_{i}_{k}`` at
    ``scale_heads.{i}.{k}``, or ``.{2k}`` where that level's
    ``nn.Sequential`` puts an upsample after each conv."""
    m = _EXTRA_CONV.match(module)
    if m is not None:
        owner = modules.get(m.group(1).rstrip('.'))
        if owner is not None and hasattr(owner, 'num_levels'):
            i = owner.num_levels + int(m.group(2))
            return _EXTRA_CONV.sub(rf'\g<1>fpn_convs.{i}', module)
    m = _SCALE_HEAD.match(module)
    if m is not None:
        level = f'{m.group(1)}scale_heads.{m.group(2)}'
        second = modules.get(f'{level}.1')
        k = int(m.group(3))
        if second is not None and not list(second.parameters()):
            k *= 2
        return _SCALE_HEAD.sub(rf'\g<1>scale_heads.{m.group(2)}.{k}',
                               module)
    return module


def port_key(path: Tuple[str, ...], collection: str = 'params',
             modules: Optional[Dict[str, nn.Module]] = None):
    """One flax leaf path → (the port's key, transform tag) for the model
    of ``modules`` (its ``named_modules()``): :func:`translate_path`, then
    what the model decides (the auxiliary heads' index, the Swin
    backbone's fork names, the necks', ``FPNHead``'s and the ViT's mmseg
    names, a shortcut behind a pool, a transposed conv brick). A bare
    kernel keeps its ``kernel`` tag: its rank decides
    (:func:`jax_to_torch_state`)."""
    modules = modules or {}
    key, tag = translate_path(path, collection)
    module, _, name = key.rpartition('.')
    if module.startswith('auxiliary_head.') and not isinstance(
            modules.get('auxiliary_head'), nn.ModuleList):
        module = 'auxiliary_head.' + module.split('.', 2)[2]
    for pattern, repl, prefix in _FORK_NAMES:
        fork = pattern.sub(repl, module)
        if fork != module and fork in modules:
            module, name = fork, prefix + name
    module = _mmseg_index(module, modules)
    key = _behind_pool(f'{module}.{name}' if module else name, modules)
    if tag == 'conv_w':
        tag = _brick_conv_tag(key, modules)
    return key, tag


def merged(key: str, modules: Dict[str, nn.Module]) -> bool:
    """Whether ``key`` is a tensor of a Swin backbone ``PatchMerging`` of
    the model (its norm or reduction), whose 4C axis takes the fork's
    order."""
    from stc_unet_tpu_torch.models.backbones.swin import PatchMerging
    owner = key.rpartition('.')[0].rpartition('.')[0]
    return isinstance(modules.get(owner), PatchMerging)


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
    (without it, never), whether a ResNet shortcut sits behind a pool,
    whether the auxiliary heads are a list and whether a tree's Swin
    blocks take the fork's names (:func:`port_key`)."""
    from stc_unet_tpu_torch.models.utils.swin_core import \
        relative_position_index
    modules = dict(model.named_modules()) if model is not None else {}
    sd: Dict[str, torch.Tensor] = {}
    for collection in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(collection, {})):
            key, tag = port_key(path, collection, modules)
            v = _float32(value)
            if tag == 'kernel' and v.ndim == 4:
                tag = _bare_4d_tag(key, modules)
            v = _transform(v, tag)
            if merged(key, modules):
                v = v[..., merge_order(v.shape[-1])]
            sd[key] = torch.from_numpy(np.ascontiguousarray(v))
            if key.endswith('.running_mean'):
                sd[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
            elif key.endswith(_BIAS_TABLE):
                # (2w - 1)² rows for a w×w window
                ws = (int(round(np.sqrt(v.shape[0]))) + 1) // 2
                sd[key[:-len('bias_table')] + 'index'] = torch.from_numpy(
                    relative_position_index((ws, ws))).long()
    return sd
