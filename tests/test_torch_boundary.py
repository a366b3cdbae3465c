"""The port stands alone: ``stc_unet_tpu_torch`` and ``chip_smoke.py``
import neither jax, flax nor the JAX package, and the port runs in a
process where jax cannot be imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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


def test_port_runs_without_jax():
    code = '''
import sys
for name in ('jax', 'jaxlib', 'flax', 'stc_unet_tpu'):
    sys.modules[name] = None
import numpy as np
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.ops import coordatt_fused
cfg = dict(
    type='EncoderDecoder',
    backbone=dict(type='UnetBackbone', in_channels=3,
                  context_layer='kernelselect', transformer_block=True,
                  channel_list=[8, 16, 16, 16]),
    decode_head=dict(type='UnetHead', se=True, num_classes=2, channels=8,
                     decoder_channel=[32, 32, 32, 32, 8]),
    test_cfg=dict(mode='slide', crop_size=(16, 16), stride=(8, 8)))
model = build_segmentor(cfg).init_weights(seed=0)
img = np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32)
metas = [dict(ori_shape=(32, 32, 3), img_shape=(32, 32, 3),
              pad_shape=(32, 32, 3), flip=False)]
pred = model(return_loss=False, img=[img], img_metas=[metas])
assert pred[0].shape == (32, 32)
assert coordatt_fused.strip_pools.launches == 0
assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))
               for m in sys.modules if sys.modules[m] is not None)
print('ok')
'''
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('ok')
