"""Helpers of the tests that hold the port's test path to the JAX package
(``tests/test_torch_pipeline.py``, ``test_torch_checkpoint.py``,
``test_torch_eval.py``): the flagship config cut to tiny widths for either
package, JAX variables drawn with numpy, and a pseudo-KiTS split."""
import os
import os.path as osp

import cv2
import jax
import numpy as np
from PIL import Image

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
STC_CONFIG = osp.join(REPO, 'my_config', 'STC-UNet.py')
MAXVIT_CONFIG = osp.join(REPO, 'my_config', 'MaxViT-UNet.py')
SLIDE = dict(mode='slide', crop_size=(16, 16), stride=(8, 8))


def tiny_config(config_cls, scale=(32, 32), flip=False, img_ratios=None,
                test_cfg=None):
    """``my_config/STC-UNet.py`` loaded by ``config_cls`` (either package's
    ``Config``) at the tiny widths of ``__graft_entry__._flagship_cfg``,
    its test pipeline's ``MultiScaleFlipAug`` at ``scale`` (and
    ``img_ratios``), with a ``RandomFlip`` after ``Resize`` when ``flip``."""
    cfg = config_cls.fromfile(STC_CONFIG)
    cfg.model.backbone.channel_list = [8, 16, 16, 16]
    cfg.model.decode_head.channels = 8
    cfg.model.decode_head.decoder_channel = [32, 32, 32, 32, 8]
    aug = cfg.data.test.pipeline[1]
    aug.img_scale = scale
    aug.flip = flip
    if img_ratios is not None:
        aug.img_ratios = img_ratios
    if flip:
        aug.transforms.insert(1, dict(type='RandomFlip'))
    if test_cfg is not None:
        cfg.test_cfg = test_cfg
    return cfg


def random_variables(module, *args, seed=0, **kwargs):
    """Variables for ``module.init(key, *args, **kwargs)``, drawn with
    numpy in the shapes ``jax.eval_shape`` gives (which compiles nothing):
    kernels uniform in ±1/sqrt(fan-in), biases within ±0.1, scales and
    running variances near 1, relative-position tables at std 0.02; the
    BN running stats too, so the eval BN is not the identity."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == 'relative_position_bias_table':
            v = rng.randn(*shape) * 0.02
        elif name in ('scale', 'var'):
            v = rng.uniform(0.8, 1.2, shape)
        else:   # bias, mean
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, dict(shapes[c]))
            for c in ('params', 'batch_stats') if c in shapes}


def jax_variables(jax_model, size=32, seed=0):
    """``random_variables`` of a JAX segmentor's net, as its ``init_weights``
    traces it."""
    import jax.numpy as jnp
    from stc_unet_tpu.models.segmentors.encoder_decoder import \
        EncoderDecoderNet
    return random_variables(jax_model.net, jnp.zeros((1, size, size, 3)),
                            seed=seed, train=False,
                            method=EncoderDecoderNet.forward_heads)


def split_classes(jax_model, imgs):
    """Shift the JAX model's ``conv_seg`` bias (in place) so that class 1
    wins on half the pixels of ``imgs``: a random STC-UNet predicts one
    class. Returns the shift."""
    logits = np.asarray(jax_model.encode_decode(imgs))
    shift = float(np.median(logits[..., 1] - logits[..., 0]))
    bias = jax_model.variables['params']['decode_head']['conv_seg']['conv']
    bias['bias'] = bias['bias'] - np.array([0, shift], np.float32)
    return shift


def write_split(root, n, size, seed=0, label_size=None):
    """``n`` pseudo-KiTS pairs in ``root``/test/{images,labels}
    (``tools/parity_eval.py:36-51``'s data: RGB noise written by cv2, a 0/1
    disc label written by Pillow). Returns the image paths."""
    rng = np.random.RandomState(seed)
    label_size = label_size or size
    for d in ('images', 'labels'):
        os.makedirs(osp.join(root, 'test', d), exist_ok=True)
    yy, xx = np.mgrid[0:label_size, 0:label_size]
    paths = []
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        cy, cx, r = rng.randint(label_size // 4, 3 * label_size // 4,
                                2).tolist() + \
            [rng.randint(label_size // 8, label_size // 3)]
        ann = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8)
        path = osp.join(root, 'test', 'images', f'case_{i:05d}.png')
        cv2.imwrite(path, img)
        Image.fromarray(ann).save(
            osp.join(root, 'test', 'labels', f'case_{i:05d}.png'))
        paths.append(path)
    return paths
