"""Rank processes of ``tests/test_torch_data_parallel.py``.

:func:`run_ranks` starts ``world`` fresh Python processes that join one
gloo group through a ``file://`` store (no TCP port, so parallel test
workers cannot collide), each with one torch thread, and runs one of the
targets below in each, ``target(rank, world, **kwargs)``. The arguments
and the results go through pickle files in the run's directory. The group
has a deadline: after it, or as soon as a rank fails, every rank is
killed and the run fails with the ranks' output.

This module imports no jax (the ranks run the port alone), so the spawned
processes, which import it again, stay jax-free.
"""
import os
import os.path as osp
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DEADLINE_S = 120


def run_ranks(workdir, target, world=2, timeout=DEADLINE_S, **kwargs):
    """``target(rank, world, **kwargs)`` on ``world`` ranks; their
    results in rank order."""
    return start_ranks(workdir, target, world, timeout, **kwargs)()


def start_ranks(workdir, target, world=2, timeout=DEADLINE_S, **kwargs):
    """Start the ranks of :func:`run_ranks` and return the function that
    waits for them (the deadline counting from now) and returns their
    results; the caller must call it, also when it fails meanwhile."""
    os.makedirs(workdir)
    with open(osp.join(workdir, 'args.pkl'), 'wb') as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=REPO)
    code = 'from tests.torch_dp_ranks import main; main()'
    deadline = time.monotonic() + timeout
    procs = []

    def finish():
        try:
            wait_all([p for p, _ in procs], deadline - time.monotonic(),
                     workdir)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
                log.close()
        out = []
        for rank in range(world):
            with open(osp.join(workdir, f'rank{rank}.pkl'), 'rb') as f:
                out.append(pickle.load(f))
        return out

    try:
        for rank in range(world):
            log = open(osp.join(workdir, f'rank{rank}.log'), 'w')
            procs.append((subprocess.Popen(
                [sys.executable, '-c', code, workdir, target, str(rank),
                 str(world)], stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=REPO,
                start_new_session=True), log))
    except BaseException:
        finish()
        raise
    return finish


def wait_all(procs, timeout, logdir):
    """Wait for every process to exit 0 within ``timeout`` seconds; fail
    (and leave the killing to the caller) with the logs in ``logdir``
    when one exits otherwise or time runs out."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            reason = f'a process failed: exit codes {codes}'
            break
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            reason = f'deadline of {timeout} s passed: exit codes {codes}'
            break
        time.sleep(0.05)
    logs = []
    for name in sorted(os.listdir(logdir)):
        if name.endswith('.log'):
            with open(osp.join(logdir, name)) as f:
                logs.append(f'--- {name}\n{f.read()[-4000:]}')
    raise AssertionError(reason + '\n' + '\n'.join(logs))


def main():
    workdir, target, rank, world = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{workdir}/store',
                            rank=rank, world_size=world)
    with open(osp.join(workdir, 'args.pkl'), 'rb') as f:
        kwargs = pickle.load(f)
    out = TARGETS[target](rank, world, **kwargs)
    with open(osp.join(workdir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors}


def _model(cfg_path, state):
    from stc_unet_tpu_torch.models import build_segmentor
    from stc_unet_tpu_torch.utils import Config
    cfg = Config.fromfile(cfg_path)
    model = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
    return cfg, model.to(memory_format=torch.channels_last)


def _rows(array, rank, world):
    b = len(array) // world
    return array[rank * b:(rank + 1) * b]


def train_steps(rank, world, cfg_path, state, img, gt, optimizer, lr_config,
                max_iters, steps):
    """``steps`` data-parallel steps on rank ``rank``'s rows of the global
    batch: each step's log vars, the parameters and the (averaged)
    gradients after the first, and the state_dict after the last; then
    the same from the same weights with ``remat=True`` (its BN
    all-reduces run again in the backward's recompute), under
    ``'remat'``."""
    from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
    from stc_unet_tpu_torch.engine import make_train_step
    from stc_unet_tpu_torch.utils import default_data_mesh
    runs = {}
    for remat in (False, True):
        _, model = _model(cfg_path, state)
        step = make_train_step(
            model, build_optimizer(model, optimizer),
            build_lr_schedule(lr_config, optimizer['lr'], max_iters),
            mesh=default_data_mesh(), remat=remat)
        out = runs[remat] = dict(logs=[])
        for i in range(steps):
            log_vars = step(_rows(img, rank, world), _rows(gt, rank, world))
            out['logs'].append({k: v.item() for k, v in log_vars.items()})
            if i == 0:
                out['g1'] = _numpy((k, p.grad)
                                   for k, p in model.named_parameters())
                out['p1'] = _numpy(model.named_parameters())
        out['state'] = _numpy(model.state_dict().items())
    return dict(runs[False], remat=runs[True])


def batchnorm_and_helpers(rank, world, x, do):
    """The global-batch ``BatchNorm`` on this rank's rows of ``x`` (NCHW)
    with the output gradient ``do``; the seed broadcast; the loss-key
    check; the pre_eval gather on unequal, empty and all-empty shards
    through the real all-gather."""
    from stc_unet_tpu_torch.apis.test import _gather_pre_eval_results
    from stc_unet_tpu_torch.apis.train import init_random_seed
    from stc_unet_tpu_torch.datasets import DistributedSampler
    from stc_unet_tpu_torch.models.bricks import BatchNorm
    from stc_unet_tpu_torch.models.segmentors.base import BaseSegmentor
    from stc_unet_tpu_torch.utils import default_data_mesh, mesh_group
    from stc_unet_tpu_torch.utils.util_distribution import allgather
    out = {}
    bn = BatchNorm(x.shape[1]).train()
    bn.process_group = mesh_group(default_data_mesh())
    g = torch.Generator().manual_seed(0)      # the same on every rank
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-1, 1, generator=g)
    xs = torch.from_numpy(_rows(x, rank, world)).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(_rows(do, rank, world))).sum().backward()
    out['bn'] = dict(y=y.detach().numpy(), dx=xs.grad.numpy(),
                     **_numpy((k, p.grad) for k, p in bn.named_parameters()),
                     **_numpy(bn.named_buffers()),
                     init=_numpy(bn.named_parameters()))
    # each rank's global np.random differs; the ranks agree on rank 0's
    np.random.seed(100 + rank)
    out['seeds'] = [init_random_seed(None),
                    DistributedSampler(range(10), seed=None).seed,
                    init_random_seed(7)]
    same = {'decode.loss_ce': 0.0, 'decode.acc_seg': 0.0}
    BaseSegmentor._check_loss_keys_consistent(same)
    differ = dict(same, **({'decode.loss_dice': 0.0} if rank else {}))
    try:
        BaseSegmentor._check_loss_keys_consistent(differ)
        out['keys_differ'] = None
    except AssertionError as e:
        out['keys_differ'] = str(e)
    rng = np.random.RandomState(rank)

    def areas(n):
        return [tuple(rng.randint(0, 100, (4, 3)).astype(np.float64))
                for _ in range(n)]

    shards = {'equal': areas(2), 'unequal': areas(3 if rank == 0 else 1),
              'empty': areas(2) if rank == 0 else [], 'all_empty': []}
    out['shards'] = shards
    # a 'spatial' axis is not ported; a 'data' axis of one rank is no mesh
    from torch.distributed.device_mesh import init_device_mesh
    from stc_unet_tpu_torch.engine import make_train_step
    mesh2 = init_device_mesh('cpu', (world, 1),
                             mesh_dim_names=('spatial', 'data'))
    plain = BatchNorm(3)
    opt = torch.optim.SGD(plain.parameters(), lr=0.1)
    try:
        make_train_step(plain, opt, mesh=mesh2)
        out['spatial'] = None
    except NotImplementedError as e:
        out['spatial'] = str(e)
    make_train_step(plain, opt, mesh=mesh2['data'])
    out['one_rank'] = (mesh_group(mesh2['data']), plain.process_group)
    out['gathered'] = {k: _gather_pre_eval_results(v, allgather)
                       for k, v in shards.items()}
    return out


def evaluation(rank, world, cfg_path, state, root, img, gt, slide_cfg):
    """``multi_gpu_test`` over the ranks' shards of the test split in
    ``root`` (pre_eval areas, label maps, formatted files); a
    ``DistEvalHook`` with
    ``save_best`` after one data-parallel step of an ``EpochBasedRunner``
    on this rank's rows of ``img``; whole and slide inference of ``img``
    sharded by ``set_mesh``."""
    from stc_unet_tpu_torch.apis import multi_gpu_test
    from stc_unet_tpu_torch.core import build_optimizer
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    from stc_unet_tpu_torch.engine import DistEvalHook, EpochBasedRunner
    from stc_unet_tpu_torch.utils import default_data_mesh
    cfg, model = _model(cfg_path, state)
    mesh = default_data_mesh()
    cfg.data.test.update(data_root=root, test_mode=True)
    loader = build_dataloader(build_dataset(cfg.data.test), 2, 0,
                              shuffle=False)
    out = dict(shard=loader.sampler.unpadded().tolist(),
               pre_eval=multi_gpu_test(model, loader, pre_eval=True),
               maps=multi_gpu_test(model, loader),
               files=multi_gpu_test(model, loader, format_only=True,
                                    format_args=dict(imgfile_prefix=osp.join(
                                        osp.dirname(cfg_path), 'format'))))
    # sharded inference of the same model
    model.set_mesh(mesh)
    x = torch.from_numpy(img)
    out['whole'] = model.encode_decode(x).numpy()
    test_cfg, model.test_cfg = model.test_cfg, dict(slide_cfg)
    out['slide'] = model.slide_inference(x, None, False).numpy()
    model.set_mesh(None)
    model.test_cfg = test_cfg
    # one step through the runner, then the hook on every rank
    work_dir = osp.join(osp.dirname(cfg_path), 'work')
    runner = EpochBasedRunner(
        model, build_optimizer(model, dict(type='SGD', lr=0.1)),
        work_dir=work_dir, max_epochs=1, mesh=mesh)
    runner.run_iter(dict(img=_rows(img, rank, world),
                         gt_semantic_seg=_rows(gt, rank, world)), True)
    hook = DistEvalHook(loader, interval=1, save_best='mDice',
                        metric='mDice')
    hook._do_evaluate(runner)
    out['hook'] = dict(
        mDice=runner.log_buffer.output['mDice'],
        best=dict(runner.meta['hook_msgs']),
        buffers=_numpy(model.named_buffers()),
        state=_numpy(model.state_dict().items()))
    return out


def device_pipeline_draws(rank, world, samples, batch, params, seed,
                          epochs):
    """This rank's shard of ``samples`` through ``build_dataloader`` and
    a ``DeviceBatchLoader`` on the CPU (its rank and world from the
    loader's sampler): each batch's images, labels and sample indices,
    epoch by epoch."""
    from stc_unet_tpu_torch.datasets import build_dataloader
    from stc_unet_tpu_torch.datasets.device_pipeline import \
        DeviceBatchLoader
    loader = DeviceBatchLoader(
        build_dataloader(samples, batch, 0, dist=True, shuffle=False,
                         seed=seed), params, seed=seed, prefetch=0,
        device='cpu')
    out = dict(rank=loader.rank, world=loader.world, epochs=[])
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out['epochs'].append([dict(img=b['img'].numpy(),
                                   gt=b['gt_semantic_seg'].numpy(),
                                   idx=b['idx'][:, 0].tolist())
                              for b in loader])
    return out


TARGETS = dict(train_steps=train_steps,
               batchnorm_and_helpers=batchnorm_and_helpers,
               evaluation=evaluation,
               device_pipeline_draws=device_pipeline_draws)
