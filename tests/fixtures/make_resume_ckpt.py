"""Write ``tests/fixtures/stc_unet_tiny_adam.ckpt``: a JAX package
checkpoint of a tiny STC-UNet with Adam's optimizer state, from which the
port resumes on the card (``chip_smoke.py``, phase ``test_cli``).

The model is ``my_config/STC-UNet.py`` at the widths of ``WIDTHS`` (small
enough that the weights and both Adam moments fit in about 130 KB), with
decode-head dropout off. Its variables are drawn with numpy
(``tests.fixtures.torch_port.random_variables``, seed 0), then the JAX
train step takes two steps with ``OPTIMIZER`` on 2 random 64² images
(seed 0), so that ``mu``, ``nu`` and ``count`` are not their initial
values. The meta holds the widths, the optimizer cfg, the classes and
the epoch and iteration counts (1 and 2). Run from the repo root with
jax on the CPU:

    JAX_PLATFORMS=cpu python -m tests.fixtures.make_resume_ckpt
"""
import os.path as osp

import jax
import numpy as np

from stc_unet_tpu.core.optimizers.builder import build_optimizer_tx
from stc_unet_tpu.engine.checkpoint import save_checkpoint
from stc_unet_tpu.engine.train_state import TrainState, make_train_step
from stc_unet_tpu.models import build_segmentor
from stc_unet_tpu.utils import Config
from tests.fixtures.torch_port import REPO, STC_CONFIG, jax_variables

OUT = osp.join(REPO, 'tests', 'fixtures', 'stc_unet_tiny_adam.ckpt')
WIDTHS = dict(channel_list=[4, 4, 4, 4], channels=4,
              decoder_channel=[8, 8, 8, 8, 4])
OPTIMIZER = dict(type='Adam', lr=1e-3, betas=[0.9, 0.999])
SIZE, STEPS = 64, 2


def main():
    cfg = Config.fromfile(STC_CONFIG)
    cfg.model.backbone.channel_list = WIDTHS['channel_list']
    cfg.model.decode_head.channels = WIDTHS['channels']
    cfg.model.decode_head.decoder_channel = WIDTHS['decoder_channel']
    cfg.model.decode_head.dropout_ratio = 0.0
    model = build_segmentor(cfg.model)
    variables = jax_variables(model, size=SIZE)
    model.variables = variables
    tx = build_optimizer_tx(OPTIMIZER, params=variables['params'])
    state = TrainState.create(variables, tx)
    step = make_train_step(model, tx, donate=False)
    rng = np.random.RandomState(0)
    img = rng.rand(2, SIZE, SIZE, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int32)
    for _ in range(STEPS):
        state, _ = step(state, img, gt, jax.random.PRNGKey(0))
    save_checkpoint(OUT, jax.device_get(state.variables),
                    opt_state=jax.device_get(state.opt_state),
                    step=int(state.step),
                    meta=dict(epoch=1, iter=STEPS, widths=WIDTHS,
                              optimizer=OPTIMIZER,
                              CLASSES=['background', 'target'],
                              PALETTE=[[0, 0, 0], [1, 1, 1]]))
    print(OUT, osp.getsize(OUT), 'bytes')


if __name__ == '__main__':
    main()
