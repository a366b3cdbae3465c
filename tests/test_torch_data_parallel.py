"""Data parallelism in the port (ROADMAP.md §1 item 14) against the JAX
package on the CPU.

The port runs one process a rank: each group here is two fresh processes
joined by gloo through a ``file://`` store, one torch thread each, with a
deadline (``tests/torch_dp_ranks.py``, which imports no jax). Rank r holds
rows ``[r·B, (r+1)·B)`` of the global batch; the JAX reference is one
program over two of conftest's virtual CPU devices, the batch sharded on
its ``'data'`` mesh axis.

Tolerances: the 2-rank step is held to JAX's mesh step and to the port's
one-process step as ``tests/test_torch_train_step.py`` holds the
one-process step to JAX's (Adam, the tiny flagship, f32, dropout off,
three steps): losses rtol 1e-5, BN running stats rtol/atol 1e-3, every
parameter within 2·steps·lr, the moves of coordinates with a strong first
gradient to lr/1000 after step 1 and 0.2·lr after three. Between the
ranks, parameters, buffers and log vars are bit-equal. The global-batch
BN module is held to the one-process BN on the concatenated batch at
rtol 1e-5 / atol 1e-6 (f32 sums in another order). Sharded inference is
held to unsharded at rtol/atol 1e-5 with the same argmax; the merged
evaluation is equal to the one-process one.
"""
import os
import os.path as osp
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from stc_unet_tpu.apis.test import \
    _gather_pre_eval_results as jax_gather
from stc_unet_tpu.core import build_lr_schedule as jax_schedule
from stc_unet_tpu.core import build_optimizer_tx
from stc_unet_tpu.datasets.builder import DataLoader as JaxLoader
from stc_unet_tpu.engine import TrainState
from stc_unet_tpu.engine import default_data_mesh as jax_mesh
from stc_unet_tpu.engine import make_train_step as jax_train_step
from stc_unet_tpu.models import build_segmentor as jax_build
from stc_unet_tpu.models.segmentors.base import BaseSegmentor as JBase
from stc_unet_tpu_torch.apis import single_gpu_test
from stc_unet_tpu_torch.apis.test import _gather_pre_eval_results
from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
from stc_unet_tpu_torch.datasets import (DataLoader, build_dataloader,
                                         build_dataset)
from stc_unet_tpu_torch.engine import make_train_step
from stc_unet_tpu_torch.models import build_segmentor
from stc_unet_tpu_torch.models.bricks import BatchNorm
from stc_unet_tpu_torch.models.segmentors.base import BaseSegmentor
from stc_unet_tpu_torch.utils import Config, jax_to_torch_state
from stc_unet_tpu_torch.utils import png
from tests.fixtures.torch_port import (REPO, SLIDE, jax_variables,
                                       tiny_config, write_split)
from tests.torch_dp_ranks import run_ranks, start_ranks, wait_all
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

WORLD, BATCH, STEPS, LR = 2, 4, 3, 1e-3
OPTIMIZER = dict(type='Adam', lr=LR, betas=(0.9, 0.999))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(n, size=32, seed=3):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, size, size, 3).astype(np.float32)
    gt = (img.mean(-1) > 0.5).astype(np.int64)
    gt[rng.rand(n, size, size) < 0.1] = 255
    return img, gt


# -- the train step ---------------------------------------------------------

@pytest.fixture(scope='module')
def dp_train(tmp_path_factory):
    """Three Adam steps of the tiny flagship on a global B=4 batch: the
    JAX mesh step over 2 devices, the port on 2 ranks, the port in one
    process; all from the same weights."""
    base = tmp_path_factory.mktemp('dp_train')
    mcfg = _flagship_cfg(tiny=True)
    mcfg['decode_head']['dropout_ratio'] = 0.0
    jm = jax_build(mcfg)
    variables = jax_variables(jm)
    state = {k: v.numpy() for k, v in jax_to_torch_state(variables).items()}
    img, gt = _batch(BATCH)
    cfg_path = str(base / 'model.py')
    Config(dict(model=mcfg)).dump(cfg_path)
    finish = start_ranks(str(base / 'ranks'), 'train_steps', world=WORLD,
                         cfg_path=cfg_path, state=state, img=img, gt=gt,
                         optimizer=OPTIMIZER, lr_config=LR_CONFIG,
                         max_iters=10, steps=STEPS)
    try:
        jax_ref, one = _references(jm, mcfg, variables, state, img, gt)
    finally:
        ranks = finish()
    return dict(mcfg=mcfg, state=state, ranks=ranks, one=one, jax=jax_ref)


def _references(jm, mcfg, variables, state, img, gt):
    """The JAX mesh step's and the one-process port step's runs."""
    tx = build_optimizer_tx(OPTIMIZER, jax_schedule(LR_CONFIG, LR, 10))
    jstate = TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                               tx)
    jstep = jax_train_step(jm, tx, mesh=jax_mesh(jax.devices()[:WORLD]),
                           donate=False)
    jax_ref = dict(logs=[])
    for i in range(STEPS):
        jstate, logs = jstep(jstate, img, gt, jax.random.PRNGKey(0))
        jax_ref['logs'].append({k: float(v) for k, v in logs.items()})
        if i == 0:
            jax_ref['p1'] = _torch_state(jstate)
    jax_ref['state'] = _torch_state(jstate)
    tm = _port(mcfg, state)
    step = make_train_step(tm, build_optimizer(tm, OPTIMIZER),
                           build_lr_schedule(LR_CONFIG, LR, 10))
    one = dict(logs=[])
    for i in range(STEPS):
        one['logs'].append({k: v.item() for k, v in step(img, gt).items()})
        if i == 0:
            one['p1'] = {k: p.detach().numpy().copy()
                         for k, p in tm.named_parameters()}
    one['state'] = {k: v.numpy() for k, v in tm.state_dict().items()}
    return jax_ref, one


def _torch_state(jstate):
    return {k: v.numpy() for k, v in
            jax_to_torch_state(_np(jstate.variables)).items()}


def _port(mcfg, state):
    tm = build_segmentor(mcfg)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                       strict=True)
    return tm.to(memory_format=torch.channels_last)


def _hold(run, ref, p0):
    """Rank 0's run against ``ref`` (JAX's or the one-process port's):
    per-step log vars, BN running stats, every parameter, and the moves
    of the strong-gradient coordinates (the checks and limits of
    ``tests/test_torch_train_step.py``'s Adam case). At this batch a
    first gradient of at least 1e-2 of the largest marks 23 % of the
    coordinates, so at least a fifth of them must take part in the
    three-step check (a quarter after step 1)."""
    for got, want in zip(run['logs'], ref['logs']):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    state, ref_state = run['state'], ref['state']
    stats = [k for k in ref_state
             if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(state[k], ref_state[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    for k, v in p0.items():
        np.testing.assert_allclose(state[k], ref_state[k], rtol=0,
                                   atol=2 * STEPS * LR, err_msg=k)
    g1 = run['g1']
    scale = max(np.abs(g).max() for g in g1.values())
    for after, floor, atol, part in ((run['p1'], 1e-3, 1e-3 * LR, 4),
                                     (state, 1e-2, 0.2 * LR, 5)):
        ref_after = ref['p1'] if after is run['p1'] else ref_state
        compared = total = 0
        for k, v0 in p0.items():
            strong = np.abs(g1[k]) >= floor * scale
            compared += int(strong.sum())
            total += strong.size
            np.testing.assert_allclose((after[k] - v0)[strong],
                                       (ref_after[k] - v0)[strong], rtol=0,
                                       atol=atol, err_msg=k)
        assert compared >= total // part, (compared, total)


def test_two_rank_steps_match_the_jax_mesh_step(dp_train):
    """The 2-rank step against JAX's step over a 2-device mesh: losses
    (global means), BN running stats (global moments), parameters and
    their moves."""
    d = dp_train
    p0 = {k: d['state'][k] for k in d['ranks'][0]['g1']}
    _hold(d['ranks'][0], d['jax'], p0)
    for k, v in d['ranks'][0]['state'].items():
        if k.endswith('num_batches_tracked'):
            assert int(v) == STEPS, k


def test_two_rank_steps_match_one_process(dp_train):
    d = dp_train
    p0 = {k: d['state'][k] for k in d['ranks'][0]['g1']}
    _hold(d['ranks'][0], d['one'], p0)


@pytest.fixture(scope='module')
def dp_aux(tmp_path_factory):
    """One Adam step of the tiny flagship with an auxiliary FCNHead (on
    the third level, weighted 0.4) on a global B=4 batch whose second
    half, rank 1's rows, has three quarters of its pixels ignored: on 2
    ranks and in one process, from the same weights."""
    base = tmp_path_factory.mktemp('dp_aux')
    mcfg = _flagship_cfg(tiny=True)
    mcfg['decode_head']['dropout_ratio'] = 0.0
    mcfg['auxiliary_head'] = dict(
        type='FCNHead', in_channels=16, in_index=2, channels=8, num_convs=1,
        concat_input=False, dropout_ratio=0.0, num_classes=2,
        norm_cfg=dict(type='BN', requires_grad=True),
        loss_decode=dict(type='CrossEntropyLoss', use_sigmoid=False,
                         loss_weight=0.4))
    state = {k: v.numpy() for k, v in jax_to_torch_state(
        jax_variables(jax_build(mcfg))).items()}
    img, gt = _batch(BATCH)
    rng = np.random.RandomState(5)
    gt[BATCH // 2:][rng.rand(BATCH // 2, 32, 32) < 0.75] = 255
    cfg_path = str(base / 'model.py')
    Config(dict(model=mcfg)).dump(cfg_path)
    ranks = run_ranks(str(base / 'ranks'), 'train_steps', world=WORLD,
                      cfg_path=cfg_path, state=state, img=img, gt=gt,
                      optimizer=OPTIMIZER, lr_config=LR_CONFIG,
                      max_iters=10, steps=1)
    tm = _port(mcfg, state)
    step = make_train_step(tm, build_optimizer(tm, OPTIMIZER),
                           build_lr_schedule(LR_CONFIG, LR, 10))
    one = {k: v.item() for k, v in step(img, gt).items()}
    return dict(ranks=ranks, one=one, labelled=(gt != 255).sum())


def test_two_rank_step_averages_every_heads_accuracy(dp_aux):
    """The ranks' log vars, auxiliary head's included, are the global
    batch's: the losses to rtol 1e-5 and each ``acc_seg`` within one of
    the global batch's labelled pixels (a pixel on a class boundary may
    flip with f32 sums taken in another order). Rank 1 holds a quarter
    as many labelled pixels as rank 0, so the plain mean of the ranks'
    accuracies would miss by several pixels."""
    d = dp_aux
    pixel = 100.0 / d['labelled']
    for run in (d['ranks'][0], d['ranks'][0]['remat']):
        logs = run['logs'][0]
        assert sorted(logs) == sorted(d['one']) == [
            'aux.acc_seg', 'aux.loss_ce', 'decode.acc_seg',
            'decode.loss_bce', 'decode.loss_dice', 'loss']
        for k, want in d['one'].items():
            if k.endswith('acc_seg'):
                assert abs(logs[k] - want) <= pixel, (k, logs[k], want)
            else:
                np.testing.assert_allclose(logs[k], want, rtol=1e-5,
                                           err_msg=k)
    assert d['ranks'][0]['logs'] == d['ranks'][1]['logs']


def test_ranks_hold_bit_equal_state(dp_train):
    """The ranks took different rows and still hold the same parameters,
    buffers (BN stats and counts) and log vars, bit for bit."""
    r0, r1 = dp_train['ranks']
    assert r0['logs'] == r1['logs']
    for k, v in r0['state'].items():
        np.testing.assert_array_equal(v, r1['state'][k], err_msg=k)
    for k, v in r0['g1'].items():
        np.testing.assert_array_equal(v, r1['g1'][k], err_msg=k)


def test_remat_ranks_are_bit_equal_and_equal_the_plain_ranks(dp_train):
    """The same 2-rank steps with ``remat=True``: the recompute runs each
    BN's global all-reduce again inside the backward, in the same order
    on both ranks, so the ranks stay bit-equal; and each rank's log vars,
    first gradients, parameters and buffers are its plain run's, bit for
    bit (the recompute repeats the same ops on the same values)."""
    r0, r1 = (r['remat'] for r in dp_train['ranks'])
    plain = dp_train['ranks'][0]
    assert r0['logs'] == r1['logs'] == plain['logs']
    for key in ('state', 'g1', 'p1'):
        for k, v in r0[key].items():
            np.testing.assert_array_equal(v, r1[key][k], err_msg=k)
            np.testing.assert_array_equal(v, plain[key][k], err_msg=k)


# -- BatchNorm, seeds, loss keys, the pre_eval gather -----------------------

@pytest.fixture(scope='module')
def helpers(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 3) * 2 + 1).astype(np.float32)
    do = rng.randn(4, 6, 5, 3).astype(np.float32)
    ranks = run_ranks(str(tmp_path_factory.mktemp('helpers') / 'ranks'),
                      'batchnorm_and_helpers', world=WORLD, x=x, do=do)
    return x, do, ranks


def test_global_batchnorm_matches_one_process(helpers):
    """Each rank normalises its rows by the global batch's moments; the
    gradient through the all-reduce reaches every rank's rows; the
    parameters' gradients sum over the ranks to the one-process ones; the
    running stats are the global batch's on both ranks."""
    x, do, ranks = helpers
    bn = BatchNorm(x.shape[1]).train()
    bn.load_state_dict({**{k: torch.from_numpy(v) for k, v in
                           ranks[0]['bn']['init'].items()},
                        **{k: bn.state_dict()[k] for k in
                           ('running_mean', 'running_var',
                            'num_batches_tracked')}})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(do)).sum().backward()
    got = [r['bn'] for r in ranks]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g['y'] for g in got]),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([g['dx'] for g in got]),
                               xt.grad.numpy(), **tol)
    for k in ('weight', 'bias'):
        np.testing.assert_allclose(got[0][k] + got[1][k],
                                   getattr(bn, k).grad.numpy(), **tol)
    for k in ('running_mean', 'running_var', 'num_batches_tracked'):
        np.testing.assert_array_equal(got[0][k], got[1][k])
        np.testing.assert_allclose(got[0][k], getattr(bn, k).numpy(), **tol)


def test_seed_broadcast_and_loss_keys_over_ranks(helpers):
    """``init_random_seed(None)`` and ``DistributedSampler(seed=None)``
    take rank 0's draw on both ranks, whose global ``np.random`` differ;
    a given seed is kept. Log vars that differ across the ranks fail on
    every rank."""
    _, _, ranks = helpers
    s0, s1 = ranks[0]['seeds'], ranks[1]['seeds']
    assert s0 == s1 and s0[2] == 7
    np.random.seed(100)
    drawn = np.random.randint(2 ** 31)
    assert s0[0] == drawn
    for r in ranks:
        assert 'different across ranks' in r['keys_differ']


def test_mesh_axes_over_ranks(helpers):
    """A mesh with a 'spatial' axis raises (item 14b); its 'data' axis of
    one rank is no mesh: the step leaves BN on the local batch."""
    _, _, ranks = helpers
    for r in ranks:
        assert 'item 14b' in r['spatial']
        assert r['one_rank'] == (None, None)


def test_gather_pre_eval_results_over_ranks(helpers):
    """The real all-gather: every rank gets rank 0's results then rank
    1's, on equal, unequal, empty and all-empty shards."""
    _, _, ranks = helpers
    for case in ranks[0]['shards']:
        want = ranks[0]['shards'][case] + ranks[1]['shards'][case]
        for r in ranks:
            got = r['gathered'][case]
            assert len(got) == len(want), case
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.stack(a), np.stack(b))


def _fake_allgather(per_call):
    """Process 0's view of ``multihost_utils.process_allgather`` over the
    values each process passes at each call (shapes must agree)."""
    calls = iter(per_call)

    def allgather(local):
        vals = [np.asarray(v) for v in next(calls)]
        assert len({v.shape for v in vals}) == 1
        return np.stack(vals)
    return allgather


def _areas(seed, n):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 100, (4, 3)).astype(np.float64))
            for _ in range(n)]


def _stack(results, n_max):
    local = np.stack([np.stack(r) for r in results]) if results else \
        np.zeros((0, 4, 3))
    return np.concatenate([local, np.zeros((n_max - len(results), 4, 3))])


@pytest.mark.parametrize('counts', [(2, 2), (3, 1), (2, 0), (0, 0)],
                         ids=['equal', 'unequal', 'empty', 'all_empty'])
def test_gather_pre_eval_results_matches_jax(counts):
    """The JAX function's cases (``tests/test_apis/test_dist_eval.py``):
    the port's gather gives the JAX one's results on the same simulated
    all-gather."""
    a, b = _areas(0, counts[0]), _areas(1, counts[1])
    n_max = max(counts)
    per_call = [[np.array([counts[0], 3 if counts[0] else 0]),
                 np.array([counts[1], 3 if counts[1] else 0])],
                [_stack(a, n_max), _stack(b, n_max)]]
    got = _gather_pre_eval_results(a, _fake_allgather(per_call))
    want = jax_gather(a, _fake_allgather(per_call))
    assert len(got) == len(want) == sum(counts)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.stack(x), np.stack(y))


def test_check_loss_keys_consistent_matches_jax():
    """Injected all-gather: equal key counts pass, a differing one
    raises, in both packages; one process checks nothing."""
    log_vars = {'decode.loss_ce': 1.0, 'decode.acc_seg': 2.0}
    for lengths, fails in (([2, 2], False), ([2, 3], True)):
        for base in (BaseSegmentor, JBase):
            check = lambda: base._check_loss_keys_consistent(  # noqa: E731
                log_vars, allgather=lambda _: np.asarray(lengths),
                process_count=2, process_index=0)
            if fails:
                with pytest.raises(AssertionError, match='different'):
                    check()
            else:
                check()
    BaseSegmentor._check_loss_keys_consistent(log_vars)


# -- the loaders ------------------------------------------------------------

@pytest.mark.parametrize('shuffle', [True, False])
def test_rank_loaders_match_the_jax_loader(shuffle):
    """Rank r's index stream (and its length in batches) is the JAX
    ``DataLoader(num_replicas=2, rank=r)``'s, epoch by epoch, through
    ``build_dataloader`` too; ``unpadded`` drops the wrapped padding, and
    the ranks' unpadded shards cover the dataset once."""
    data = list(range(11))
    shards = []
    for rank in range(WORLD):
        ours = DataLoader(data, 2, shuffle=shuffle, num_workers=0, seed=5,
                          num_replicas=WORLD, rank=rank)
        built = build_dataloader(data, 2, 0, shuffle=shuffle, seed=5,
                                 num_replicas=WORLD, rank=rank)
        theirs = JaxLoader(data, 2, shuffle=shuffle, num_workers=0, seed=5,
                           num_replicas=WORLD, rank=rank)
        for epoch in range(3):
            for loader in (ours, built, theirs):
                loader.set_epoch(epoch)
            want = theirs.sampler.indices().tolist()
            assert ours.sampler.indices().tolist() == want
            assert built.sampler.indices().tolist() == want
            assert len(ours) == len(built) == len(theirs)
        shards.append(ours.sampler.unpadded().tolist())
    assert sorted(shards[0] + shards[1]) == data


# -- the augmentation on the device ------------------------------------------

_AUG = dict(crop_size=(8, 8), mean=(0., 0., 0.), std=(255., 255., 255.),
            flip_prob=0.5, photo_metric=True)


def _aug_samples(n=8, hw=16):
    """Pseudo host samples (``DeviceFormatBundle``'s uint8 output, its
    valid extent and the dataset index); samples 2k and 2k + 1 hold the
    same image, labels and extent."""
    rng = np.random.RandomState(0)
    out = []
    for k in range(n // 2):
        img = rng.randint(0, 255, (hw, hw, 3), dtype=np.uint8)
        gt = rng.randint(0, 2, (hw, hw)).astype(np.uint8)
        valid = np.array([rng.randint(9, hw + 1), rng.randint(9, hw + 1)],
                         np.int32)
        out += [dict(img=img, gt_semantic_seg=gt, valid_hw=valid,
                     idx=np.array([i])) for i in (2 * k, 2 * k + 1)]
    return out


def _one_process(samples, batches, epoch, seed):
    """The one-process ``DeviceBatchLoader`` over the given global batches
    (lists of sample indices) in pass ``epoch``."""
    from stc_unet_tpu_torch.datasets.builder import collate
    from stc_unet_tpu_torch.datasets.device_pipeline import \
        DeviceBatchLoader
    from tests.test_torch_device_pipeline import _ListLoader
    loader = DeviceBatchLoader(
        _ListLoader([collate([samples[i] for i in b]) for b in batches]),
        _AUG, seed=seed, prefetch=0, device='cpu')
    assert (loader.rank, loader.world) == (0, 1)
    loader.set_epoch(epoch)
    return list(loader)


def test_ranks_draw_their_own_rows_of_the_global_batch(tmp_path):
    """Two gloo ranks, each with its shard of the samples
    (``build_dataloader(dist=True)``) behind a ``DeviceBatchLoader``: the
    ranks draw apart (their batches hold the same images, and no two come
    out alike), and rank r's batch i is rows ``[r·B, (r+1)·B)`` of the
    one-process program on the global batch, the ranks' samples in rank
    order, bit for bit, in every epoch."""
    samples, batch, seed, epochs = _aug_samples(), 2, 5, 2
    ranks = run_ranks(str(tmp_path / 'ranks'), 'device_pipeline_draws',
                      world=WORLD, samples=samples, batch=batch,
                      params=_AUG, seed=seed, epochs=epochs)
    assert [(r['rank'], r['world']) for r in ranks] == [(0, 2), (1, 2)]
    for epoch in range(epochs):
        mine = [r['epochs'][epoch] for r in ranks]
        assert len(mine[0]) == len(mine[1]) == 2
        whole = _one_process(samples, [a['idx'] + b['idx']
                                       for a, b in zip(*mine)], epoch, seed)
        for i, (a, b) in enumerate(zip(*mine)):
            assert [j // 2 for j in a['idx']] == [j // 2 for j in b['idx']]
            assert not np.array_equal(a['img'], b['img']), (epoch, i)
            for r, part in enumerate((a, b)):
                rows = slice(r * batch, (r + 1) * batch)
                np.testing.assert_array_equal(
                    part['img'], whole[i]['img'][rows].numpy())
                np.testing.assert_array_equal(
                    part['gt'], whole[i]['gt_semantic_seg'][rows].numpy())


def test_one_process_draws_the_program_on_its_batch():
    """In one process a batch is the global one: the loader's output is
    the program's on the batch with the batch's generator, bit for bit,
    as before the ranks drew their own rows."""
    from stc_unet_tpu_torch.datasets.builder import collate
    from stc_unet_tpu_torch.datasets.device_pipeline import (
        batch_seed, make_device_train_pipeline)
    samples = _aug_samples()
    out = _one_process(samples, [[0, 3, 4], [7, 1, 2]], 3, seed=5)
    fn = make_device_train_pipeline(**_AUG)
    for i, got in enumerate(out):
        b = collate([samples[j] for j in ([0, 3, 4], [7, 1, 2])[i]])
        img, gt = fn(torch.Generator().manual_seed(batch_seed(5, 3, i)),
                     torch.from_numpy(b['img']),
                     torch.from_numpy(b['gt_semantic_seg']), b['valid_hw'])
        assert torch.equal(got['img'], img)
        assert torch.equal(got['gt_semantic_seg'], gt)


# -- evaluation and sharded inference ---------------------------------------

@pytest.fixture(scope='module')
def evaluation(tmp_path_factory):
    """The tiny flagship on 2 ranks: ``multi_gpu_test`` over 5 test
    images, a ``DistEvalHook`` after one data-parallel step, and sharded
    whole and slide inference of 3 images."""
    base = tmp_path_factory.mktemp('evaluation')
    root = str(base / 'data')
    write_split(root, 5, 32, seed=4)
    cfg = tiny_config(Config)
    cfg.model.decode_head.dropout_ratio = 0.0
    cfg_path = str(base / 'cfg.py')
    cfg.dump(cfg_path)
    tm = build_segmentor(cfg.model).init_weights(seed=3)
    state = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    img, gt = _batch(3, seed=6)
    ranks = run_ranks(str(base / 'ranks'), 'evaluation', world=WORLD,
                      cfg_path=cfg_path, state=state, root=root, img=img,
                      gt=gt[:2], slide_cfg=SLIDE)
    cfg.data.test.update(data_root=root, test_mode=True)
    return dict(cfg=cfg, state=state, ranks=ranks, img=img, base=base)


def test_multi_gpu_test_matches_single_gpu_test(evaluation):
    """Each rank runs its shard; every rank gets the whole split's
    pre_eval areas and label maps in the dataset's order, equal to
    ``single_gpu_test``'s in one process, and the same metrics; with
    ``format_only`` rank 0 writes the split's label PNGs, whose names
    every rank gets."""
    e = evaluation
    tm = _port(e['cfg'].model, e['state'])
    dataset = build_dataset(e['cfg'].data.test)
    loader = build_dataloader(dataset, 2, 0, shuffle=False, dist=False)
    pre = single_gpu_test(tm, loader, pre_eval=True)
    maps = single_gpu_test(tm, loader)
    shards = [r['shard'] for r in e['ranks']]
    assert shards == [[0, 2, 4], [1, 3]]
    for r in e['ranks']:
        assert len(r['pre_eval']) == len(pre) == 5
        for got, want in zip(r['pre_eval'], pre):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for got, want in zip(r['maps'], maps):
            np.testing.assert_array_equal(got, want)
        merged = dataset.evaluate(r['pre_eval'], metric=['mIoU', 'mDice'])
        assert merged == dataset.evaluate(pre, metric=['mIoU', 'mDice'])
    files = e['ranks'][0]['files']
    assert e['ranks'][1]['files'] == files
    assert [osp.basename(f) for f in files] == \
        [f'case_{i:05d}.png' for i in range(5)]
    for f, want in zip(files, maps):
        np.testing.assert_array_equal(png.read(f), want)


def test_dist_eval_hook_merges_before_evaluate(evaluation):
    """After a data-parallel step the ranks' BN buffers are equal (so
    ``broadcast_bn_buffer`` has nothing to do); the hook evaluates the
    merged results of both shards on every rank, which take the same
    mDice (that of the whole split in one process) and the same
    ``save_best`` decision, and only rank 0 writes the checkpoint."""
    e = evaluation
    h0, h1 = (r['hook'] for r in e['ranks'])
    for k, v in h0['buffers'].items():
        np.testing.assert_array_equal(v, h1['buffers'][k], err_msg=k)
    assert h0['mDice'] == h1['mDice']
    assert h0['best'] == h1['best']
    assert h0['best']['best_ckpt'].endswith('best_mDice_epoch_1.pth')
    tm = _port(e['cfg'].model, h0['state'])
    dataset = build_dataset(e['cfg'].data.test)
    loader = build_dataloader(dataset, 2, 0, shuffle=False, dist=False)
    want = dataset.evaluate(single_gpu_test(tm, loader, pre_eval=True),
                            metric='mDice')['mDice']
    assert h0['mDice'] == want
    work = e['base'] / 'work'
    assert sorted(os.listdir(work)) == ['best_mDice_epoch_1.pth']


@pytest.mark.parametrize('mode', ['whole', 'slide'])
def test_sharded_inference_matches_unsharded(evaluation, mode):
    """3 images (whole) or their 27 tiles (slide), padded to 2 ranks'
    chunks: every rank gets the unsharded logits."""
    e = evaluation
    tm = _port(e['cfg'].model, e['state'])
    x = torch.from_numpy(e['img'])
    if mode == 'whole':
        want = tm.encode_decode(x).numpy()
    else:
        tm.test_cfg = dict(SLIDE)
        want = tm.slide_inference(x, None, False).numpy()
    for r in e['ranks']:
        np.testing.assert_allclose(r[mode], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r[mode].argmax(-1), want.argmax(-1))


# -- the CLIs under the launcher --------------------------------------------

TINY = ['model.backbone.channel_list=[8,16,16,16]',
        'model.decode_head.channels=8',
        'model.decode_head.decoder_channel=[32,32,32,32,8]']


def _launch(argv, cwd, log, nproc=WORLD):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m <argv>`` on the CPU, one torch thread a rank, within 120 s
    (its ranks killed with it after that)."""
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(nproc), '-m'] + argv
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=REPO)
    with open(log, 'w') as f:
        proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=f,
                                stderr=subprocess.STDOUT, env=env,
                                cwd=str(cwd), start_new_session=True)
        try:
            wait_all([proc], 120, str(osp.dirname(log)))
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(log) as f:
        return f.read()


@pytest.fixture(scope='module')
def launched(tmp_path_factory):
    """The train CLI on 2 ranks: (its work dir, the launcher's output,
    the data root)."""
    base = tmp_path_factory.mktemp('launched')
    root = str(base / 'data')
    write_split(root, 4, 32, seed=1)
    work = base / 'work'
    argv = ['--cfg-options'] + TINY + [
            'model.decode_head.channels=8',
            'model.decode_head.decoder_channel=[32,32,32,32,8]',
            f'data.train.data_root={root}', f'data.val.data_root={root}',
            'data.train.img_dir=test/images',
            'data.train.ann_dir=test/labels',
            'data.train.pipeline.2.img_scale=(40,40)',
            'data.train.pipeline.3.crop_size=(32,32)',
            'data.train.pipeline.7.size=(32,32)',
            'data.val.pipeline.1.img_scale=(32,32)',
            'data.samples_per_gpu=1', 'data.workers_per_gpu=0',
            'runner.max_epochs=1', 'checkpoint_config.interval=1',
            'log_config.interval=1',
            "log_config.hooks=[{'type': 'TextLoggerHook'}]"]
    out = _launch(['stc_unet_tpu_torch.tools.train',
                   osp.join(REPO, 'my_config', 'STC-UNet.py'), '--launcher',
                   'pytorch', '--device', 'cpu', '--seed', '0',
                   '--work-dir', str(work)] + argv, base,
                  str(base / 'launcher.log'))
    return work, out, root


def test_train_cli_under_the_launcher(launched):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    stc_unet_tpu_torch.tools.train <tiny cfg> --launcher pytorch --device
    cpu`` (the config's ``dist_params.backend='jax'``: gloo on the CPU)
    trains one epoch on 4 images, 1 a rank a step, evaluating through
    ``DistEvalHook``; only rank 0 writes the config, the logs and the
    checkpoints."""
    work, out, _ = launched
    names = sorted(os.listdir(work))
    logs = [n for n in names if n.endswith('.log')]
    jsons = [n for n in names if n.endswith('.log.json')]
    assert {'epoch_1.pth', 'latest.pth', 'STC-UNet.py'} <= set(names)
    assert len(logs) == 1 and len(jsons) == 1, names
    assert not [n for n in names if n.endswith('.tmp')]
    with open(work / logs[0]) as f:
        text = f.read()
    assert 'Distributed training: True' in text
    assert 'Epoch [1][2/2]' in text and 'mDice' in text
    # rank 1 logs errors only: every INFO line comes from rank 0
    assert out.count('Distributed training: True') == 1, out[-3000:]


def test_test_cli_under_the_launcher(launched, tmp_path):
    """The test CLI on 2 ranks over the trained checkpoint evaluates the
    split's shards through ``multi_gpu_test``; rank 0 alone writes the
    metrics JSON and ``--out``, whose results are the whole split's in
    order, equal to the CLI's in one process."""
    import json
    import pickle
    from stc_unet_tpu_torch.tools import test as test_cli
    work, _, root = launched
    images = osp.join(root, 'test', 'images')
    argv = [images, str(work / 'STC-UNet.py'), str(work / 'latest.pth'),
            '--eval', 'mIoU', 'mDice', '--device', 'cpu', '--cfg-options',
            'data.test.pipeline.1.img_scale=(32,32)', 'data.workers_per_gpu=0']
    out = _launch(['stc_unet_tpu_torch.tools.test'] + argv +
                  ['--launcher', 'pytorch', '--work-dir', str(tmp_path / 'w'),
                   '--out', str(tmp_path / 'out.pkl')], tmp_path,
                  str(tmp_path / 'launcher.log'))
    jsons = os.listdir(tmp_path / 'w')
    assert len(jsons) == 1, jsons
    with open(tmp_path / 'w' / jsons[0]) as f:
        metric = json.load(f)['metric']
    assert out.count('"mDice"') == 1          # printed by rank 0 alone
    with open(tmp_path / 'out.pkl', 'rb') as f:
        results = pickle.load(f)
    want = test_cli.main(argv + ['--work-dir', str(tmp_path / 'one')])
    assert len(results) == len(want) == 4
    for got, ref in zip(results, want):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with open(tmp_path / 'one' / os.listdir(tmp_path / 'one')[0]) as f:
        assert json.load(f)['metric'] == metric


# -- bounded waits ----------------------------------------------------------

def test_a_lost_feeder_fails_the_pass_instead_of_hanging(monkeypatch):
    """The ``DeviceBatchLoader`` consumer waits for its feeder thread's
    batches, end of pass or error; when the thread is gone with none of
    them queued (here every hand-over is lost), the pass fails within
    seconds instead of waiting forever."""
    from stc_unet_tpu_torch.datasets import device_pipeline
    from tests.test_torch_device_pipeline import _PARAMS, _ListLoader, \
        _u8_batches
    monkeypatch.setattr(device_pipeline.queue.Queue, 'put',
                        lambda self, item, timeout=None: None)
    loader = device_pipeline.DeviceBatchLoader(
        _ListLoader(_u8_batches(n=2)), _PARAMS, prefetch=2, device='cpu')
    with pytest.raises(RuntimeError, match='feeder thread ended'):
        list(loader)
