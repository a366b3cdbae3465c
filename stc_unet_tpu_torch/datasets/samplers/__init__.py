from .distributed_sampler import DistributedSampler

__all__ = ['DistributedSampler']
