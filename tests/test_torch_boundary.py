"""The port stands alone: ``stc_unet_tpu_torch`` and ``chip_smoke.py``
import neither jax, flax nor the JAX package, and the port runs in a
process where jax cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'stc_unet_tpu', 'mmseg',
             '__graft_entry__')


def _port_files():
    files = sorted((REPO / 'stc_unet_tpu_torch').rglob('*.py'))
    return files + [REPO / 'chip_smoke.py']


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad


_STC_UNET = '''
cfg = dict(
    type='EncoderDecoder',
    backbone=dict(type='UnetBackbone', in_channels=3,
                  context_layer='kernelselect', transformer_block=True,
                  channel_list=[8, 16, 16, 16]),
    decode_head=dict(type='UnetHead', se=True, num_classes=2, channels=8,
                     decoder_channel=[32, 32, 32, 32, 8]),
    test_cfg=dict(mode='slide', crop_size=(16, 16), stride=(8, 8)))
size = 32
'''
_STC_UNET_FLASH = _STC_UNET.replace('transformer_block=True,',
                                    'transformer_block=True, '
                                    'flash_attention=True,')
_MAXVIT_UNET = '''
cfg = dict(
    type='EncoderDecoder',
    backbone=dict(type='MaxViT', in_channels=3, depths=(1, 1, 1, 1),
                  channels=(8, 8, 8, 8), embed_dim=8, num_heads=2,
                  grid_window_size=(2, 2), attn_drop=0.1, drop=0.1,
                  drop_path=0.1, mlp_ratio=2),
    decode_head=dict(type='MaxViTDecoder', in_channels=[8, 8, 8, 8],
                     output_size=(32, 32), num_heads=2,
                     grid_window_size=(2, 2), depths=(1, 1, 1), channels=8,
                     num_classes=2, mlp_ratio=2.0),
    test_cfg=dict(mode='whole'))
size = 64
'''


@pytest.mark.parametrize('model', [_STC_UNET, _STC_UNET_FLASH, _MAXVIT_UNET],
                         ids=['stc_unet', 'stc_unet_flash', 'maxvit_unet'])
def test_port_runs_without_jax(model):
    """A tiny STC-UNet (slide, with and without the flash path) and a
    tiny MaxViT-UNet (whole) serve a request in a process where jax, flax
    and the JAX package cannot be imported; on the CPU no kernel is
    launched."""
    code = '''
import sys
for name in ('jax', 'jaxlib', 'flax', 'stc_unet_tpu'):
    sys.modules[name] = None
import numpy as np
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.ops import coordatt_fused, window_attention
from stc_unet_tpu_torch.ops.flash_attention import flash_attention_forward
''' + model + '''
model = build_segmentor(cfg).init_weights(seed=0)
img = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
metas = [dict(ori_shape=(size, size, 3), img_shape=(size, size, 3),
              pad_shape=(size, size, 3), flip=False)]
pred = model(return_loss=False, img=[img], img_metas=[metas])
assert pred[0].shape == (size, size)
assert coordatt_fused.strip_pools.launches == 0
assert window_attention.window_attention.launches == 0
assert flash_attention_forward.launches == 0
assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))
               for m in sys.modules if sys.modules[m] is not None)
print('ok')
'''
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('ok')
