"""DistributedSampler (≙ ``stc_unet_tpu/datasets/samplers/
distributed_sampler.py`` and the JAX loader's ``EpochSampler``): one rank's
index stream, the train loader's (``datasets/builder.py``) included.

Every rank draws the same ``seed + epoch`` permutation from its own
``numpy.random.RandomState``, the index list is wrapped (as often as
needed) to a multiple of ``num_replicas * batch_size`` (cut down to one
with ``drop_last``), and each rank takes its ``rank::num_replicas`` strided
slice: equal, disjoint shards of whole batches. ``batch_size=1`` is the
JAX ``DistributedSampler``; the loader's ``batch_size`` is the JAX
``EpochSampler``. No process group is needed: ``num_replicas`` and
``rank`` default to the initialised ``torch.distributed`` group, else to
one process. ``seed=None`` takes rank 0's draw in a group of more than
one rank (``sync_random_seed``), so every rank permutes alike.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from stc_unet_tpu_torch.utils.util_distribution import (get_dist_info,
                                                        sync_random_seed)


class DistributedSampler:

    def __init__(self, dataset, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: Optional[int] = 0, batch_size: int = 1,
                 drop_last: bool = False) -> None:
        group_rank, group_size = get_dist_info()
        if num_replicas is None:
            num_replicas = group_size
        if rank is None:
            rank = group_rank
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f'Invalid rank {rank}, rank should be in the interval '
                f'[0, {num_replicas - 1}]')
        if seed is None:
            if num_replicas > 1 and group_size != num_replicas:
                raise ValueError(
                    f'DistributedSampler: seed=None over {num_replicas} '
                    f'replicas needs their process group (init_dist) to '
                    f'share a seed; pass seed')
            seed = sync_random_seed()
        self.n = len(dataset)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        step = num_replicas * batch_size
        self.total_size = (self.n // step if drop_last else
                           -(-self.n // step)) * step
        self.num_samples = self.total_size // num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch) \
                .permutation(self.n)
        else:
            order = np.arange(self.n)
        order = np.resize(order, self.total_size)
        return order[self.rank::self.num_replicas]

    def unpadded(self) -> np.ndarray:
        """The rank's indices without the wrapped padding, which ends
        its stream: what an evaluation over the shards counts once."""
        return self.indices()[:len(range(self.rank,
                                         min(self.n, self.total_size),
                                         self.num_replicas))]

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
