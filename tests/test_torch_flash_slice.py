"""The STC-UNet flash-attention path of the port against the JAX package's,
on the CPU: ``UnetBackbone(flash_attention=True)`` at tiny widths
(``__graft_entry__._flagship_cfg(tiny=True)``), in whole and slide
inference and one train step.

JAX's flash path calls the library's Pallas flash attention, which runs on
the CPU only in interpret mode (``pltpu.force_tpu_interpret_mode()``) and
only at lengths that are multiples of its 128-row blocks: so the images are
256² (x4 has 1024 tokens, x5 256) or, in the train step, 256 x 128. The
JAX model is initialised with the flag off, outside the interpret context
(the init traces the flash call too; the flag has no parameters), and the
same variables are applied with it on inside the context. The port loads
them through ``jax_to_torch_state`` with ``strict=True``.

Tolerances, f32: the logits to rtol 1e-4 / atol 1e-5, as
``tests/test_torch_stc_unet.py``; the train step as
``tests/test_torch_train_step.py``: losses rtol 1e-5, gradients rtol 1e-3 /
atol 3e-5 of the largest, BN running stats rtol 1e-4 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _flagship_cfg
from stc_unet_tpu.core import build_optimizer_tx
from stc_unet_tpu.engine import TrainState
from stc_unet_tpu.engine import make_train_step as jax_train_step
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.encoder_decoder import EncoderDecoderNet
from stc_unet_tpu_torch.core import build_optimizer
from stc_unet_tpu_torch.engine import make_train_step
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import jax_to_torch_state
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SLIDE = dict(mode='slide', crop_size=(256, 256), stride=(170, 170))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(flash, dropout=None):
    cfg = _flagship_cfg(tiny=True)
    cfg['backbone']['flash_attention'] = flash
    if dropout is not None:
        cfg['decode_head']['dropout_ratio'] = dropout
    return cfg


def _jax_variables(jm, seed=0, size=32):
    """The JAX init of the model with the flag off (jitted: one compile),
    with the BN running stats drawn at random."""
    init = jax.jit(lambda rng, x: jm.net.init(
        {'params': rng, 'dropout': rng}, x, train=False,
        method=EncoderDecoderNet.forward_heads))
    v = init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)

    def stats(tree):
        return {k: stats(t) if hasattr(t, 'items') else (
            rng.uniform(-0.2, 0.2, t.shape) if k == 'mean'
            else rng.uniform(0.8, 1.2, t.shape)).astype(np.float32)
            for k, t in tree.items()}

    return {'params': _np(dict(v['params'])),
            'batch_stats': stats(v['batch_stats'])}


def _port(cfg, variables):
    tm = build_segmentor(cfg)
    tm.load_state_dict(jax_to_torch_state(variables), strict=True)
    return tm.to(memory_format=torch.channels_last)


@pytest.fixture(scope='module')
def variables():
    return _jax_variables(jax_build(_cfg(False)))


@pytest.mark.parametrize('mode', ['whole', 'slide'])
def test_flash_logits_match_jax(variables, mode):
    """Whole at 256², slide on a 256 x 426 image (two 256² tiles, stride
    170), B=1, f32; the port on the CPU takes the plain versions of Lf."""
    jm = jax_build(_cfg(True))
    jm.variables = variables
    tm = _port(_cfg(True), variables)
    width = 256 if mode == 'whole' else 426
    img = np.random.RandomState(1).rand(1, 256, width, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if mode == 'whole':
            ref = jm.encode_decode(img)
        else:
            jm.test_cfg = dict(SLIDE)
            ref = jm.slide_inference(img, None, False)
    tm.test_cfg = dict(mode=mode, **({} if mode == 'whole' else {
        k: v for k, v in SLIDE.items() if k != 'mode'}))
    with torch.no_grad():
        out = (tm.encode_decode(img) if mode == 'whole'
               else tm.slide_inference(img, None, False))
    assert out.shape == (1, 256, width, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_flash_train_step_matches_jax(variables):
    """One make_train_step step with the flash path (SGD at lr 1, so that
    JAX's gradient is p0 - p1 to an ulp of p) against JAX's
    make_train_step in interpret mode: the losses, the gradient of every
    parameter and the BN running stats. B=1 at 256 x 128 (x4: 512 tokens,
    x5: 128), which halves the interpret-mode backward of 256²."""
    cfg = _cfg(True, dropout=0.0)
    jm = jax_build(cfg)
    rng = np.random.RandomState(3)
    img = rng.rand(1, 256, 128, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(1, 256, 128) < 0.1] = 255
    ocfg = dict(type='SGD', lr=1.0)
    tx = build_optimizer_tx(ocfg, None)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                              tx)
    with pltpu.force_tpu_interpret_mode():
        state, jlogs = jax_train_step(jm, tx, donate=False)(
            state, img, gt, jax.random.PRNGKey(0))
        jlogs = {k: float(v) for k, v in jlogs.items()}
    new = _np(state.variables)
    tm = _port(cfg, variables)
    step = make_train_step(tm, build_optimizer(tm, ocfg))
    logs = step(img, gt)
    assert sorted(logs) == sorted(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(logs[k].item(), jlogs[k], rtol=1e-5,
                                   err_msg=k)
    p0 = jax_to_torch_state({'params': variables['params']})
    p1 = jax_to_torch_state({'params': new['params']})
    jgrad = {k: p0[k] - p1[k] for k in p0}
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(grads) == sorted(jgrad)
    assert all(k in grads for k in ('backbone.aspp4.tr.0.ma.in_proj_weight',
                                    'backbone.aspp5.tr.3.ma.in_proj_bias'))
    scale = max(g.abs().max().item() for g in jgrad.values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrad[k].numpy(), rtol=1e-3,
                                   atol=3e-5 * scale, err_msg=k)
    ref = jax_to_torch_state(new)
    sd = tm.state_dict()
    stats = [k for k in ref if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.slow
def test_full_width_flash_logits_match_jax():
    """``my_config/STC-UNet.py`` at full width with
    ``backbone.flash_attention=True``, whole mode at 256² (x4 has 1024
    tokens, x5 256: multiples of the library's 128-row blocks), f32; JAX's
    library kernel in interpret mode. The limits of the full-width
    einsum test (``tests/test_torch_stc_unet.py``): rtol 1e-4, atol
    1e-4."""
    import os.path as osp
    from stc_unet_tpu_torch.utils import Config
    path = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    'my_config', 'STC-UNet.py')
    cfg = Config.fromfile(path)
    cfg.model.pretrained = None
    cfg.model.backbone.flash_attention = False
    variables = _jax_variables(jax_build(cfg.model), size=64)
    cfg.model.backbone.flash_attention = True
    jm = jax_build(cfg.model)
    jm.variables = variables
    tm = _port(cfg.model, variables)
    img = np.random.RandomState(2).rand(1, 256, 256, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.encode_decode(img)
    with torch.no_grad():
        out = tm.encode_decode(img).numpy()
    ref = np.asarray(ref)
    assert out.shape == (1, 256, 256, 2)
    print(f'flash whole 256: max abs error {np.abs(out - ref).max()}, '
          f'|max| {np.abs(ref).max()}')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
