"""Dataset and pipeline registries, ``build_dataset``, ``collate`` and the
thread-pool loader (≙ ``stc_unet_tpu/datasets/builder.py``).

As in the JAX package, batches are numpy NHWC stacks: the segmentor moves
them to its device. The loader's threads overlap PNG decoding (zlib and the
C unfilter release the GIL) with the model. The sampler pads the last batch
to full size with the first indices, as the JAX loader does, and
``single_gpu_test`` drops the padded results.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

import numpy as np

from stc_unet_tpu_torch.utils import Registry

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')

_WRAPPERS = ('RepeatDataset', 'ConcatDataset', 'MultiImageMixDataset')


def build_dataset(cfg, default_args=None):
    """Build a dataset from cfg (≙ the JAX ``build_dataset``). The dataset
    wrappers of ``dataset_wrappers.py`` (a list of cfgs, the wrapper types,
    list-valued ``img_dir`` or ``split``) and the image cache are not
    ported yet."""
    if isinstance(cfg, (list, tuple)) or cfg['type'] in _WRAPPERS or \
            isinstance(cfg.get('img_dir'), (list, tuple)) or \
            isinstance(cfg.get('split'), (list, tuple)):
        raise NotImplementedError(
            'dataset wrappers (Concat/Repeat/MultiImageMix) are not ported '
            'yet (ROADMAP.md §1, Item 20: dataset_wrappers.py)')
    for step in _pipeline_steps(cfg.get('pipeline', [])):
        if step.get('cache') is not None:
            raise NotImplementedError(
                'the image cache is not ported yet (ROADMAP.md §1, Item 12b: '
                'pipelines/img_cache.py)')
    return DATASETS.build(cfg, default_args=default_args)


def _pipeline_steps(steps):
    for step in steps:
        if isinstance(step, dict):
            yield step
            yield from _pipeline_steps(step.get('transforms', []))


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


class EpochSampler:
    """The index stream of the JAX loader (≙ reference
    ``samplers/distributed_sampler.py:13``): every rank draws the same
    seed+epoch permutation from its own ``np.random.RandomState``, pads it
    to a multiple of num_replicas * batch_size with its first indices, and
    takes a rank-strided slice."""

    def __init__(self, n: int, shuffle: bool, seed: int, num_replicas: int,
                 rank: int, batch_size: int, drop_last: bool = False):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed or 0
        self.num_replicas = num_replicas
        self.rank = rank
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(self.n)
        else:
            order = np.arange(self.n)
        step = self.num_replicas * self.batch_size
        if self.drop_last:
            total = (len(order) // step) * step
            order = order[:total]
        else:
            total = int(np.ceil(len(order) / step)) * step
            if total > len(order) and len(order) > 0:
                pad = np.resize(order, total - len(order))
                order = np.concatenate([order, pad])
        return order[self.rank::self.num_replicas]

    def __len__(self):
        return len(self.indices()) // self.batch_size


class DataLoader:
    """Thread-pool batch loader over a map-style dataset: yields collated
    numpy batches, two batches loading ahead of the one being consumed.
    ``num_workers=0`` loads inline. Each iteration owns its pool and shuts
    it down when it ends or is closed."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: Optional[int] = None,
                 num_replicas: int = 1, rank: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.sampler = EpochSampler(len(dataset), shuffle, seed or 0,
                                    num_replicas, rank, batch_size, drop_last)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def _batches(self):
        indices = self.sampler.indices()
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(indices) // self.batch_size)]

    def __iter__(self):
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return
        ahead = 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            try:
                for b in batches:
                    pending.append([pool.submit(self.dataset.__getitem__,
                                                int(i)) for i in b])
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
                     rank: int = 0, **kwargs):
    """Build the loader (≙ the JAX ``build_dataloader``): batches of
    ``samples_per_gpu * num_gpus`` from ``workers_per_gpu`` threads.
    ``dist``, ``pin_memory`` and ``persistent_workers`` are accepted for
    the reference's argv and change nothing: one process feeds one card."""
    batch_size = samples_per_gpu * max(num_gpus, 1)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=workers_per_gpu, seed=seed,
                      num_replicas=num_replicas or 1, rank=rank,
                      drop_last=drop_last)
