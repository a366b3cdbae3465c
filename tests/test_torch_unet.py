"""The port's U-Net (``my_config/U-Net.py``: ``EncoderDecoder`` with
``UnetBackbone`` and ``UnetHead``, every STC flag off) against the JAX
package, on the CPU, at the tiny widths of the flagship's tests (channels
8, 16, 16, 16; decoder 32, 32, 32, 32, 8) and 32² images. Helpers and
tolerances: ``tests/fixtures/torch_monolithic.py`` (logits rtol 1e-4 /
atol 1e-5, three Adam steps)."""
import os.path as osp

import numpy as np
import pytest

from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.utils import Config
from tests.fixtures import torch_monolithic as mono
from tests.fixtures.torch_port import REPO
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SIZE = 32
SLIDE = dict(mode='slide', crop_size=(16, 16), stride=(8, 8))


def _cfg(dropout_ratio=0.1):
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'U-Net.py'))
    cfg.model.backbone.channel_list = [8, 16, 16, 16]
    cfg.model.decode_head.channels = 8
    cfg.model.decode_head.decoder_channel = [32, 32, 32, 32, 8]
    cfg.model.decode_head.dropout_ratio = dropout_ratio
    model = cfg.to_dict()['model']
    model['test_cfg'] = dict(mode='whole')
    return model


@pytest.fixture(scope='module')
def models():
    return mono.build_pair(_cfg(), SIZE)


def test_every_flax_leaf_maps_to_a_port_key(models):
    _, tm = models
    assert mono.check_leaves_and_count(*models) == 27930
    keys = tm.state_dict()
    # every STC flag off: no KSA branches, transformer or CoordAtt
    assert not [k for k in keys if 'context_layer' in k or '.tr.' in k or
                '.ca.' in k]
    assert 'decode_head.up4.conv.conv.0.weight' in keys


@pytest.mark.parametrize('mode', ['whole', 'slide'])
def test_logits_match_jax(models, mode):
    jm, tm = models
    if mode == 'whole':
        mono.check_logits(jm, tm, SIZE)
        return
    img = mono.image(2, SIZE)
    jm.test_cfg = tm.test_cfg = dict(SLIDE)
    try:
        ref = np.asarray(jm.slide_inference(img, None, False))
        out = tm.slide_inference(img, None, False).numpy()
    finally:
        jm.test_cfg = tm.test_cfg = dict(mode='whole')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_train_steps_match_jax(models):
    jm, _ = models
    cfg = _cfg(dropout_ratio=0.0)
    img, gt = mono.train_batch(SIZE)
    mono.check_train_steps(
        cfg, img, gt, mono.jax_train_run(cfg, jm.variables, img, gt))


def test_config_builds_at_full_width():
    cfg = Config.fromfile(osp.join(REPO, 'my_config', 'U-Net.py'))
    m = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    assert sum(p.numel() for p in m.parameters()) == 13395394
    assert m.out_channels == 2
