"""The port's weight bridge, configs and resize against the JAX package.

- ``jax_to_torch_state`` is the exact inverse of the JAX package's
  ``convert_state_dict`` (every leaf round-trips bit for bit);
- the port's ``state_dict`` keys are the reference fork's
  (``tests/fixtures/torch_stc_unet.py``), and a fork checkpoint loads
  with ``strict=True`` and gives the fork model's logits;
- ``Config.fromfile`` gives the same dict in both packages;
- ``resize`` matches the JAX ``resize``.
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from __graft_entry__ import _flagship_cfg
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu.ops import resize as jax_resize
from stc_unet_tpu.utils import Config as JaxConfig
from stc_unet_tpu.utils.torch_convert import convert_state_dict
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.ops import resize
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from tests.fixtures.torch_stc_unet import (CH, DEC, _TorchSTCUNet,
                                           prefixed_state_dict)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _fixture_cfg(ch=CH, dec=DEC):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='UnetBackbone', in_channels=3, channel_list=ch,
                      context_layer='kernelselect', transformer_block=True),
        decode_head=dict(type='UnetHead', se=True, num_classes=2,
                         channels=dec[4], decoder_channel=dec),
        test_cfg=dict(mode='whole'))


def test_bridge_inverts_convert_state_dict_exactly():
    """Every leaf of a JAX STC-UNet tree (its shapes from the JAX model,
    its values random) comes back bit for bit through
    ``convert_state_dict(jax_to_torch_state(v))``."""
    jm = jax_build(_flagship_cfg(tiny=True))
    shapes = jax.eval_shape(lambda rng, x: jm.net.init(
        {'params': rng, 'dropout': rng}, x, train=False,
        method=EncoderDecoderNet.forward_heads),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    params, batch_stats = convert_state_dict(jax_to_torch_state(v))
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat({'params': v['params'],
                      'batch_stats': v['batch_stats']}))
    got = dict(flat({'params': params, 'batch_stats': batch_stats}))
    assert want.keys() == got.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_state_dict_keys_are_the_fork_keys():
    tm = build_segmentor(_fixture_cfg())
    ref = prefixed_state_dict(_TorchSTCUNet(stc=True))
    got = tm.state_dict()
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].shape == v.shape, k


def test_fork_checkpoint_loads_strict_and_matches_the_fork(tmp_path):
    from stc_unet_tpu_torch.apis import init_segmentor
    torch.manual_seed(0)
    fork = _TorchSTCUNet(stc=True).eval()
    with torch.no_grad():
        for m in fork.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.2)
    ckpt = tmp_path / 'fork.pth'
    torch.save(dict(state_dict=prefixed_state_dict(fork),
                    meta=dict(CLASSES=('bg', 'kidney'))), ckpt)
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text(f'model = {_fixture_cfg()!r}\n')
    model = init_segmentor(str(cfg_file), str(ckpt), device='cpu')
    assert model.CLASSES == ('bg', 'kidney')
    x = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        expected = fork(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = model.encode_decode(x).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), expected.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize('name', ['STC-UNet.py', 'U-Net.py', 'DC-UNet.py',
                                  'UNet++.py', 'TransUnet.py',
                                  'SwinUnet.py'])
def test_config_fromfile_matches_jax(name):
    path = osp.join(REPO, 'my_config', name)
    cfg, jcfg = Config.fromfile(path), JaxConfig.fromfile(path)
    assert cfg.to_dict() == jcfg.to_dict()
    opts = {'model.decode_head.threshold': 0.5,
            'test_cfg': dict(mode='slide', crop_size=(256, 256),
                             stride=(170, 170))}
    cfg.merge_from_dict(opts)
    jcfg.merge_from_dict(opts)
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.pretty_text == jcfg.pretty_text


@pytest.mark.parametrize('name,params,bn_stats', [
    ('U-Net.py', 13395394, 7936), ('DC-UNet.py', 10811124, 34288),
    ('UNet++.py', 17204098, 10112), ('TransUnet.py', 67865730, 17472),
    ('SwinUnet.py', 41545318, 0)])
def test_full_config_builds_with_the_jax_sizes(name, params, bn_stats):
    """Each config builds at full width on the CPU with the JAX model's
    parameter and BN running-stat counts (``jax.eval_shape`` of its init
    at 512², counted on the CPU)."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', name))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == params
    assert sum(b.numel() for k, b in m.named_buffers()
               if k.endswith(('running_mean', 'running_var'))) == bn_stats


@pytest.mark.parametrize('shape,kw', [
    ((2, 8, 8, 3), dict(size=(16, 16))),
    ((1, 7, 5, 2), dict(size=(13, 11))),
    ((1, 13, 11, 2), dict(size=(7, 5))),
    ((2, 8, 6, 4), dict(scale_factor=2)),
    ((1, 5, 5, 1), dict(scale_factor=0.5)),
])
@pytest.mark.parametrize('align', [True, False])
def test_resize_matches_jax(shape, kw, align):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), mode='bilinear', align_corners=align,
                     warning=False, **kw)
    out = resize(torch.from_numpy(x), mode='bilinear', align_corners=align,
                 warning=False, **kw)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# -- the brick ConvTranspose2d ----------------------------------------------

@pytest.mark.parametrize('cin,cout,k,s,p,op', [
    (8, 8, 2, 2, 0, 0),      # ResUNet's up1-up3, MultiResUnet's upsample
    (6, 6, 3, 2, 1, 1),      # LinkNet's tp_conv (C/4 -> C/4)
    (6, 5, 3, 2, 1, 1),      # LinkNet's tp_conv1 (in != out)
])
def test_brick_deconv_is_flipped_by_the_bridge(monkeypatch, cin, cout, k,
                                               s, p, op):
    """The JAX ``ConvTranspose2d`` brick keeps its kernel at
    ``conv/kernel`` (kh, kw, in, out); landing on a port
    ``ConvTranspose2d``, the bridge flips it into (in, out, kh, kw), and
    the output matches JAX's. With the conv tag it had before (OIHW,
    unflipped) a kernel of in = out loads and gives another output; one
    of in != out does not load."""
    from stc_unet_tpu.models.bricks import ConvTranspose2d as JaxDeconv
    from stc_unet_tpu_torch.models.bricks import ConvTranspose2d
    from stc_unet_tpu_torch.utils import jax_convert
    from tests.fixtures.torch_port import random_variables
    x = np.random.RandomState(k + cout).randn(2, 5, 4, cin).astype(
        np.float32)
    jmod = JaxDeconv(cout, k, s, p, op)
    v = random_variables(jmod, jnp.asarray(x), seed=1)
    ref = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    mod = ConvTranspose2d(cin, cout, k, s, p, op)
    mod.load_state_dict(jax_to_torch_state(v, mod), strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(out.shape) == ref.shape == (2, 5 * s, 4 * s, cout)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(jax_convert, '_brick_conv_tag',
                        lambda key, modules: 'conv_w')
    old = jax_to_torch_state(v, mod)
    if cin != cout:
        with pytest.raises(RuntimeError, match='size mismatch'):
            mod.load_state_dict(old, strict=True)
        return
    mod.load_state_dict(old, strict=True)
    with torch.no_grad():
        wrong = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert np.abs(wrong.numpy() - ref).max() > 1e-2


def _tiny(name, **head):
    """``my_config/<name>`` as a model dict, its decode head updated."""
    cfg = Config.fromfile(osp.join(REPO, 'my_config', name))
    cfg.model.decode_head.update(head)
    return cfg.to_dict()['model']


def _earlier_models():
    """Tiny models of every earlier slice (their CPU tests' widths)."""
    unet = Config.fromfile(osp.join(REPO, 'my_config', 'U-Net.py'))
    unet.model.backbone.channel_list = [8, 16, 16, 16]
    unet.model.decode_head.update(channels=8,
                                  decoder_channel=[32, 32, 32, 32, 8])
    psp = Config.fromfile(osp.join(REPO, 'my_config', 'PSPNet.py'))
    psp.model.backbone.update(stem_channels=8, base_channels=8)
    psp.model.decode_head.update(in_channels=256, channels=8)
    maxvit = dict(
        type='EncoderDecoder',
        backbone=dict(type='MaxViT', in_channels=3, depths=(1, 1, 1, 1),
                      channels=(8, 8, 8, 8), embed_dim=8, num_heads=2,
                      grid_window_size=(2, 2), mlp_ratio=2),
        decode_head=dict(type='MaxViTDecoder', in_channels=[8, 8, 8, 8],
                         output_size=(32, 32), num_heads=2,
                         grid_window_size=(2, 2), depths=(1, 1, 1),
                         channels=8, num_classes=2, mlp_ratio=2.0))
    return {
        'STC-UNet': (_fixture_cfg(), 32),
        'U-Net': (unet.to_dict()['model'], 32),
        'DC-UNet': (_tiny('DC-UNet.py', nf=4), 32),
        'UNet++': (_tiny('UNet++.py'), 32),
        'TransUNet': (dict(type='EncoderDecoderFull', decode_head=dict(
            type='TransUNet', img_dim=32, in_channels=3, out_channels=16,
            head_num=4, mlp_dim=32, block_num=2, patch_dim=16,
            class_num=2)), 32),
        'SwinUNet': (dict(type='EncoderDecoderFull', decode_head=dict(
            type='SwinUNet', img_size=64, patch_size=8, window_size=4,
            out_channel=8, num_classes=2)), 64),
        'MaxViT-UNet': (maxvit, 64),
        'PSPNet': (psp.to_dict()['model'], 64),
    }


@pytest.mark.parametrize('name', ['STC-UNet', 'U-Net', 'DC-UNet', 'UNet++',
                                  'TransUNet', 'SwinUNet', 'MaxViT-UNet',
                                  'PSPNet'])
def test_earlier_models_keep_their_state_dicts(monkeypatch, name):
    """Each earlier model's state dict from a JAX tree (numpy-drawn in the
    JAX init's shapes) is the one the bridge gave before it learnt the
    brick ``ConvTranspose2d``: key for key and bit for bit (none of them
    has one: DC-UNet's and MaxViT's transposed convs are bare flax
    kernels, turned by the module type as before)."""
    from stc_unet_tpu_torch.utils import jax_convert
    from tests.fixtures.torch_port import random_variables
    cfg, size = _earlier_models()[name]
    jm = jax_build(cfg)
    v = random_variables(jm.net, jnp.zeros((1, size, size, 3)), train=False,
                         method=EncoderDecoderNet.forward_heads)
    tm = build_segmentor(cfg)
    new = jax_to_torch_state(v, tm)
    monkeypatch.setattr(jax_convert, '_brick_conv_tag',
                        lambda key, modules: 'conv_w')
    old = jax_to_torch_state(v, tm)
    assert list(new) == list(old)
    for k, t in old.items():
        assert new[k].dtype == t.dtype and torch.equal(new[k], t), k
    tm.load_state_dict(new, strict=True)
