"""Test API (≙ ``stc_unet_tpu/apis/test.py``): ``single_gpu_test``.

``multi_gpu_test`` comes with DDP (ROADMAP.md §1, Item 14), and showing
or writing out the painted results (``show``, ``out_dir``) with the
segmentor's ``show_result``, which is not ported yet.
"""
from __future__ import annotations

import warnings


def single_gpu_test(model, data_loader, show=False, out_dir=None,
                    efficient_test=False, opacity=0.5, pre_eval=False,
                    format_only=False, format_args=None):
    """Run the model over a loader on its device (≙ the JAX
    ``single_gpu_test``). Returns the label maps, their ``pre_eval``
    area 4-tuples, or the files ``format_results`` wrote, by the flags
    (at most one of ``efficient_test``, ``pre_eval`` and ``format_only``).
    The loader pads its last batch to full size; the padded results are
    dropped, so the results align with the dataset."""
    if show or out_dir:
        raise NotImplementedError(
            'single_gpu_test: show and out_dir need the segmentor\'s '
            'show_result, which is not ported yet')
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
