"""Test API (≙ ``stc_unet_tpu/apis/test.py``): ``single_gpu_test`` over
a loader on one card, and ``multi_gpu_test`` over the ranks' shards of
it, merged into what ``single_gpu_test`` gives on the whole split.
"""
from __future__ import annotations

import os.path as osp
import warnings

import numpy as np
import torch.distributed as dist

from stc_unet_tpu_torch.utils.image import imdenormalize, imresize
from stc_unet_tpu_torch.utils.util_distribution import (allgather,
                                                        get_dist_info)


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


def multi_gpu_test(model, data_loader, tmpdir=None, gpu_collect=False,
                   efficient_test=False, pre_eval=False, format_only=False,
                   format_args=None):
    """``single_gpu_test`` on this rank's shard of ``data_loader`` (built
    with ``dist=True``), merged over the ranks (≙ the JAX
    ``multi_gpu_test``): every rank returns the results of the whole
    split in the dataset's order, as ``single_gpu_test`` gives them in
    one process. ``pre_eval`` areas are merged by
    :func:`_gather_pre_eval_results`, label maps through
    ``all_gather_object``. With ``format_only`` rank 0 formats the merged
    label maps and every rank gets the file names. ``tmpdir`` and
    ``gpu_collect`` are accepted for the reference's argv and change
    nothing, as in the JAX package. Every rank must make the call."""
    results = single_gpu_test(model, data_loader,
                              efficient_test=efficient_test,
                              pre_eval=pre_eval)
    rank, world = get_dist_info()
    indices = data_loader.sampler.unpadded().tolist()
    if world > 1 and pre_eval:
        results = _gather_pre_eval_results(results, allgather)
        indices = _gather_indices(indices, allgather)
    elif world > 1:
        parts = [None] * world
        dist.all_gather_object(parts, (indices, results))
        indices = [i for part, _ in parts for i in part]
        results = [r for _, part in parts for r in part]
    order = np.argsort(indices, kind='stable')
    results = [results[i] for i in order]
    if not format_only:
        return results
    files = [None]
    if rank == 0:
        files[0] = data_loader.dataset.format_results(
            results, indices=sorted(indices), **(format_args or {}))
    if world > 1:
        dist.broadcast_object_list(files, 0)
    return files[0]


def _gather_pre_eval_results(results, allgather):
    """All-gather the ranks' pre_eval 4-tuples in rank order, robust to
    unequal and empty shards (≙ the JAX function, line for line).

    ``allgather`` maps a local array of shape S to the stacked (P, *S)
    one. Each rank pads its stack to the largest count, the counts (and
    the class count, which an empty rank cannot know) are gathered first,
    and the padding rows are masked out after the gather."""
    local = (np.stack([np.stack(r) for r in results]).astype(np.float64)
             if results else None)
    # gather (count, num_classes) so even an empty rank can build a
    # shape-agreeing padded stack (the gather needs identical shapes)
    meta = np.asarray([len(results),
                       local.shape[-1] if local is not None else 0])
    metas = np.asarray(allgather(meta)).reshape(-1, 2)
    counts, n_max = metas[:, 0], int(metas[:, 0].max())
    if n_max == 0:
        return []
    num_classes = int(metas[:, 1].max())
    if local is None:
        local = np.zeros((0, 4, num_classes), np.float64)
    pad = np.zeros((n_max - local.shape[0],) + local.shape[1:], local.dtype)
    gathered = np.asarray(allgather(np.concatenate([local, pad], axis=0)))
    out = []
    for proc, n in enumerate(counts.tolist()):
        out.extend(tuple(row) for row in gathered[proc, :int(n)])
    return out


def _gather_indices(indices, allgather):
    """The ranks' dataset indices in rank order (the order of
    :func:`_gather_pre_eval_results`): padded with -1 to the longest
    shard, gathered, the padding dropped."""
    n_max = int(np.asarray(allgather(np.asarray(len(indices)))).max())
    local = np.full(n_max, -1, np.int64)
    local[:len(indices)] = indices
    gathered = np.asarray(allgather(local)).reshape(-1)
    return gathered[gathered >= 0].tolist()


def _batch_indices(data_loader):
    """The dataset indices of each batch of the loader, its padding left
    out (a loader without a sampler: the dataset in order)."""
    batch_size = getattr(data_loader, 'batch_size', 1)
    sampler = getattr(data_loader, 'sampler', None)
    if sampler is None:
        indices = list(range(len(data_loader.dataset)))
    else:
        indices = sampler.unpadded().tolist()
    for i in range(0, len(data_loader) * batch_size, batch_size):
        yield indices[i:i + batch_size]


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
