"""Test API (≙ ``stc_unet_tpu/apis/test.py``): ``single_gpu_test``.

``multi_gpu_test`` comes with DDP (ROADMAP.md §1, Item 14).
"""
from __future__ import annotations

import os.path as osp
import warnings

import numpy as np

from stc_unet_tpu_torch.utils.image import imdenormalize, imresize


def single_gpu_test(model, data_loader, show=False, out_dir=None,
                    efficient_test=False, opacity=0.5, pre_eval=False,
                    format_only=False, format_args=None):
    """Run the model over a loader on its device (≙ the JAX
    ``single_gpu_test``). Returns the label maps, their ``pre_eval``
    area 4-tuples, or the files ``format_results`` wrote, by the flags
    (at most one of ``efficient_test``, ``pre_eval`` and ``format_only``).
    The loader pads its last batch to full size; the padded results are
    dropped, so the results align with the dataset. With ``out_dir`` each
    image is painted with its label map (``show_result`` at ``opacity``)
    and written to ``out_dir/<ori_filename>``; ``show`` (a window)
    raises."""
    if efficient_test:
        warnings.warn('efficient_test is deprecated; results are '
                      'accumulated as compact pre_eval areas instead')
    if [efficient_test, pre_eval, format_only].count(True) > 1:
        raise ValueError('``efficient_test``, ``pre_eval`` and '
                         '``format_only`` are mutually exclusive')
    model.eval()
    results = []
    dataset = data_loader.dataset
    for batch_indices, data in zip(_batch_indices(data_loader), data_loader):
        result = model(return_loss=False, rescale=True,
                       **_as_test_kwargs(data))
        result = result[:len(batch_indices)]
        if show or out_dir:
            _visualize(model, data, result, out_dir, opacity, dataset,
                       show)
        if format_only:
            result = dataset.format_results(
                result, indices=batch_indices, **(format_args or {}))
        if pre_eval:
            result = dataset.pre_eval(result, indices=batch_indices)
        results.extend(result)
    return results


def _batch_indices(data_loader):
    batch_size = getattr(data_loader, 'batch_size', 1)
    n = len(data_loader.dataset)
    for i in range(0, n, batch_size):
        yield list(range(i, min(i + batch_size, n)))


def _as_test_kwargs(data):
    """Collated test batches carry aug-major lists already; batches
    without test-time augmentation are wrapped into 1-aug lists."""
    img = data['img']
    img_metas = data['img_metas']
    if not isinstance(img, list):
        img = [img]
    if img_metas and not isinstance(img_metas[0], list):
        img_metas = [img_metas]
    return dict(img=img, img_metas=img_metas)


def painted_image(img, meta):
    """The BGR uint8 image that ``out_dir`` paints over, from a test
    batch's (normalised, HWC) image and its meta: denormalised, cropped to
    ``img_shape``, truncated to uint8 and resized to ``ori_shape``."""
    h, w = meta['img_shape'][:2]
    img_show = np.asarray(img)[:h, :w]
    norm = meta.get('img_norm_cfg')
    if norm is not None:
        img_show = imdenormalize(img_show, norm['mean'], norm['std'],
                                 to_bgr=norm.get('to_rgb', False))
    img_show = np.clip(img_show, 0, 255).astype(np.uint8)
    ori_h, ori_w = meta['ori_shape'][:-1]
    return imresize(img_show, (ori_w, ori_h))


def _visualize(model, data, result, out_dir, opacity, dataset, show):
    """Paint each image of a batch (its first augmentation,
    :func:`painted_image`) with its label map, as the JAX ``_visualize``.
    The padded images of a last batch, which have no result, are skipped
    (the JAX function fails on them)."""
    imgs = data['img'][0] if isinstance(data['img'], list) else data['img']
    metas = data['img_metas'][0] if isinstance(data['img_metas'][0], list) \
        else data['img_metas']
    for i, (img, meta, seg) in enumerate(zip(imgs, metas, result)):
        img_show = painted_image(img, meta)
        out_file = None
        if out_dir:
            out_file = osp.join(out_dir, meta.get('ori_filename') or
                                f'{i}.png')
        model.show_result(img_show, [np.asarray(seg)],
                          palette=getattr(dataset, 'PALETTE', None),
                          show=show, out_file=out_file, opacity=opacity)
