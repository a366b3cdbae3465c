"""Ranks, the process group and the data mesh
(≙ ``stc_unet_tpu/utils/util_distribution.py``).

The JAX package runs one process a host, and one program shards a global
batch over the host's devices along a ``('data',)`` mesh axis; XLA inserts
the collectives. The port runs one process a card, as torch launches its
jobs (``python -m torch.distributed.run``): rank r holds rows ``[r·B,
(r+1)·B)`` of the global batch, and the train step, ``BatchNorm``, the
sharded inference and the evaluation exchange explicitly, through
``torch.distributed``, what the JAX program exchanges.

A data mesh here is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
named ``('data',)`` (:func:`default_data_mesh`), or a process group;
:func:`mesh_group` turns either into the group the collectives use, and
a mesh of one rank into None, which every caller treats as one process.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                 'MASTER_PORT')


def _torch_backend(backend: str, device_type: str) -> str:
    """The torch backend of a config's ``dist_params.backend``: ``'jax'``
    (what the KiTS configs carry) is NCCL on the card and gloo on the
    CPU; ``'nccl'`` and ``'gloo'`` are taken as given."""
    if backend == 'jax':
        return 'nccl' if device_type == 'cuda' else 'gloo'
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f'dist backend {backend!r}: the port takes nccl, '
                         f'gloo or jax')
    return backend


def init_dist(launcher: str = 'pytorch', backend: str = 'nccl',
              device='cuda', **kwargs) -> torch.device:
    """Join the process group that ``python -m torch.distributed.run``
    set up (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return the rank's device: ``cuda:LOCAL_RANK``
    for a ``device`` on the card, made current. Under gloo, ranks beyond
    the card count share the cards (``LOCAL_RANK`` modulo the count:
    two ranks on one card); NCCL needs a card a rank. ``backend`` as
    :func:`_torch_backend` maps it. A group that cannot be formed raises:
    there is no single-process fallback."""
    if launcher != 'pytorch':
        raise NotImplementedError(
            f'launcher {launcher!r}: the port launches one process a card '
            f'with python -m torch.distributed.run (--launcher pytorch)')
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f'init_dist: {missing} not set; start the ranks with python -m '
            f'torch.distributed.run --nproc_per_node N')
    device = torch.device(device)
    backend = _torch_backend(backend, device.type)
    local_rank = int(os.environ['LOCAL_RANK'])
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('init_dist: CUDA is not available; pass the '
                               'CLI --device cpu to run the ranks on the '
                               'CPU')
        count = torch.cuda.device_count()
        if backend == 'nccl' and local_rank >= count:
            raise RuntimeError(
                f'init_dist: NCCL needs a card a rank; local rank '
                f'{local_rank} of a machine with {count} (gloo shares '
                f'cards: --cfg-options dist_params.backend=gloo)')
        device = torch.device('cuda', local_rank % count)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=int(os.environ['RANK']),
                            world_size=int(os.environ['WORLD_SIZE']))
    return device


def get_dist_info(group=None) -> Tuple[int, int]:
    """(rank, world size) of the process group (default: the world), or
    (0, 1) when no group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def default_data_mesh():
    """A 1-D ``('data',)`` device mesh over every rank of the initialised
    group (≙ the JAX ``default_data_mesh``, a ``('data',)`` mesh over the
    devices). Its device type follows the backend: ``cuda`` for NCCL,
    ``cpu`` for gloo (whose ranks may share a card or run on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError('default_data_mesh: no process group; call '
                           'init_dist first')
    from torch.distributed.device_mesh import init_device_mesh
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=('data',))


def mesh_group(mesh) -> Optional[dist.ProcessGroup]:
    """The process group of a data mesh (a ``DeviceMesh`` named
    ``('data',)``, or a process group as it is), or None for no mesh and
    a mesh of one rank, which have nothing to exchange. Any other axis
    (the JAX ``'spatial'`` one, H-sharded whole inference) raises."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names != ('data',):
            raise NotImplementedError(
                f'mesh axes {mesh.mesh_dim_names}: only a 1-D (\'data\',) '
                f'mesh is ported; the \'spatial\' axis (H-sharded whole '
                f'inference) is not (ROADMAP.md §1, item 14b)')
        group = mesh.get_group('data')
    elif isinstance(mesh, dist.ProcessGroup):
        group = mesh
    else:
        raise TypeError(f'mesh: a DeviceMesh or a ProcessGroup, got '
                        f'{type(mesh).__name__}')
    return group if dist.get_world_size(group) > 1 else None


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors must live: the current card for
    NCCL, the CPU for gloo."""
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def allgather(array, group=None) -> np.ndarray:
    """Every rank's ``array`` stacked in rank order, ``(P, *S)``
    (``multihost_utils.process_allgather``'s contract); the shapes and
    dtypes must agree across the ranks."""
    t = torch.as_tensor(np.asarray(array)).to(comm_device(group))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out).cpu().numpy()


def sync_random_seed(seed: Optional[int] = None) -> int:
    """One seed for every rank: ``seed``, or a draw from the global
    ``np.random``, taken from rank 0 by a broadcast in a group of more
    than one rank (the reference's ``sync_random_seed``)."""
    if seed is None:
        seed = int(np.random.randint(2 ** 31))
    rank, world = get_dist_info()
    if world == 1:
        return int(seed)
    t = torch.tensor(seed if rank == 0 else 0, dtype=torch.int64,
                     device=comm_device())
    dist.broadcast(t, 0)
    return int(t.item())


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the incoming
    gradient the same way (each rank's input reaches every rank's
    output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def broadcast_tensors(tensors, group, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with the group rank ``src``'s,
    one broadcast per dtype (the tensors of a dtype packed into one
    buffer)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    src = dist.get_global_rank(group, src)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in same])
        dist.broadcast(flat, src, group=group)
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
