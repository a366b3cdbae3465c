"""Dataset and pipeline registries, ``build_dataset``, ``collate`` and the
thread-pool loader (≙ ``stc_unet_tpu/datasets/builder.py``).

As in the JAX package, batches are numpy NHWC stacks: the segmentor (or
the runner, through pinned memory) moves them to the card. The loader's
threads overlap PNG decoding (zlib and the C unfilter release the GIL) and
the train transforms with the model. The sampler pads the last batch to
full size with the first indices, as the JAX loader does, and
``single_gpu_test`` drops the padded results.

Each sample's random draws come from a ``numpy.random.RandomState`` of its
own, seeded from (seed, epoch, rank, position in the rank's epoch)
(:func:`sample_seed`). A batch is thus a pure function of those four,
whatever ``workers_per_gpu`` is and however the threads are scheduled.
This is the port's counterpart of the JAX ``worker_init_fn``
(``builder.py:292``): the JAX package's thread workers share the global
``np.random``, so its draws are not reproducible at ``workers_per_gpu >
0``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

import numpy as np

from stc_unet_tpu_torch.utils import Registry
from stc_unet_tpu_torch.utils.util_distribution import get_dist_info
from .samplers import DistributedSampler

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')

_WRAPPERS = ('RepeatDataset', 'ConcatDataset', 'MultiImageMixDataset')


def build_dataset(cfg, default_args=None):
    """Build a dataset from cfg (≙ the JAX ``build_dataset``). The dataset
    wrappers of ``dataset_wrappers.py`` (a list of cfgs, the wrapper types,
    list-valued ``img_dir`` or ``split``) are not ported yet."""
    if isinstance(cfg, (list, tuple)) or cfg['type'] in _WRAPPERS or \
            isinstance(cfg.get('img_dir'), (list, tuple)) or \
            isinstance(cfg.get('split'), (list, tuple)):
        raise NotImplementedError(
            'dataset wrappers (Concat/Repeat/MultiImageMix) are not ported '
            'yet (ROADMAP.md §1, Item 20: dataset_wrappers.py)')
    return DATASETS.build(cfg, default_args=default_args)


def inject_img_cache(dataset_cfg, mode, cache_dir=None):
    """Set ``cache=mode`` (and ``cache_dir``) on every ``LoadImageFromFile``
    and ``LoadAnnotations`` of a dataset cfg's pipeline, nested ones
    (``MultiScaleFlipAug``'s) included, that sets no cache of its own
    (≙ the JAX ``inject_img_cache``, for ``data.img_cache``). Mutates and
    returns ``dataset_cfg``."""

    def walk(steps):
        for step in steps:
            if not isinstance(step, dict):
                continue
            if step.get('type') in ('LoadImageFromFile',
                                    'LoadAnnotations') and \
                    'cache' not in step:
                step['cache'] = mode
                if cache_dir is not None:
                    step['cache_dir'] = cache_dir
            if isinstance(step.get('transforms'), (list, tuple)):
                walk(step['transforms'])

    walk(dataset_cfg.get('pipeline', []))
    return dataset_cfg


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of pipeline outputs into a model batch.

    Arrays with a common shape are stacked on a new leading axis;
    ``img_metas`` (and any non-array value) becomes a list. Test-time
    augmentation samples (dict of lists from ``MultiScaleFlipAug``)
    collate aug-major: ``img[aug]`` is an (N, ...) stack and
    ``img_metas[aug]`` a list of N dicts.
    """
    if not samples:
        raise ValueError('collate: no samples')
    elem = samples[0]
    batch: Dict[str, Any] = {}
    for key in elem:
        values = [s[key] for s in samples]
        if isinstance(elem[key], list):
            num_augs = len(elem[key])
            if num_augs and isinstance(elem[key][0], np.ndarray):
                batch[key] = [
                    np.stack([v[a] for v in values]) for a in range(num_augs)]
            else:
                batch[key] = [[v[a] for v in values] for a in range(num_augs)]
        elif isinstance(elem[key], np.ndarray):
            batch[key] = np.stack(values)
        else:
            batch[key] = values
    return batch


class EpochSampler(DistributedSampler):
    """The loader's index stream in the JAX loader's signature (≙ the
    JAX ``builder.EpochSampler``): :class:`DistributedSampler` over ``n``
    samples in whole batches of ``batch_size``; its length counts a
    rank's batches."""

    def __init__(self, n: int, shuffle: bool, seed: int, num_replicas: int,
                 rank: int, batch_size: int, drop_last: bool = False):
        super().__init__(range(n), num_replicas, rank, shuffle, seed or 0,
                         batch_size, drop_last)
        self.batch_size = batch_size

    def __len__(self):
        return self.num_samples // self.batch_size


def sample_seed(seed: int, epoch: int, rank: int, position: int):
    """The seed of one sample's ``RandomState``: ``[seed mod 2^32, epoch,
    rank, position]`` (numpy seeds from such a list through
    ``init_by_array``)."""
    return [int(seed) % 2 ** 32, int(epoch), int(rank), int(position)]


class DataLoader:
    """Thread-pool batch loader over a map-style dataset: yields collated
    numpy batches, two batches loading ahead of the one being consumed.
    ``num_workers=0`` loads inline. Each iteration owns its pool and shuts
    it down when it ends or is closed. A dataset with a ``load(idx, rng)``
    method (``CustomDataset``) gets each sample's generator
    (:func:`sample_seed`); any other is indexed."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: Optional[int] = None,
                 num_replicas: int = 1, rank: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed or 0
        self.sampler = EpochSampler(len(dataset), shuffle, self.seed,
                                    num_replicas, rank, batch_size, drop_last)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def _batches(self):
        """Batches of (position in the rank's epoch, dataset index)."""
        indices = list(enumerate(self.sampler.indices()))
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(indices) // self.batch_size)]

    def _sample(self, position: int, idx: int):
        load = getattr(self.dataset, 'load', None)
        if load is None:
            return self.dataset[int(idx)]
        s = self.sampler
        return load(int(idx), np.random.RandomState(
            sample_seed(self.seed, s.epoch, s.rank, position)))

    def __iter__(self):
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                yield collate([self._sample(*p) for p in b])
            return
        ahead = 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            try:
                for b in batches:
                    pending.append([pool.submit(self._sample, *p)
                                    for p in b])
                    if len(pending) > ahead:
                        yield collate([f.result() for f in pending.pop(0)])
                while pending:
                    yield collate([f.result() for f in pending.pop(0)])
            finally:
                for futures in pending:
                    for f in futures:
                        f.cancel()


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int,
                     num_gpus: int = 1, dist: bool = True,
                     shuffle: bool = True, seed: Optional[int] = None,
                     drop_last: bool = False,
                     num_replicas: Optional[int] = None,
                     rank: Optional[int] = None, **kwargs):
    """Build the loader (≙ the JAX ``build_dataloader``): batches of
    ``samples_per_gpu * num_gpus`` from ``workers_per_gpu`` threads, each
    epoch a ``seed + epoch`` permutation with ``shuffle``, the last batch
    padded to full size unless ``drop_last``; each sample's draws seeded
    by :func:`sample_seed`. With ``dist`` the loader is one rank's shard
    (``num_replicas`` and ``rank``, by default those of the initialised
    process group, else one process); without it, the whole dataset.
    ``pin_memory`` and ``persistent_workers`` are accepted for the
    reference's argv and change nothing: the runner stages each batch in
    pinned memory."""
    group_rank, group_size = get_dist_info() if dist else (0, 1)
    batch_size = samples_per_gpu * max(num_gpus, 1)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=workers_per_gpu, seed=seed,
                      num_replicas=num_replicas or group_size,
                      rank=group_rank if rank is None else rank,
                      drop_last=drop_last)
