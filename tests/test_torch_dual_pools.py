"""Kernel P (``stc_unet_tpu_torch/ops/dual_pools.py``) without a card.

P's CUDA kernel runs only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``), and its plain version is held to the probe's Pallas
kernel in ``test_torch_flash_attention.py``. Here: its launch plan
(``dual_plan``: vectors or one element a lane from the shape and the
alignment alone, bands of at most 64 rows, how the bands meet, no N or W
limit below 2^31 - 1 blocks); a numpy model of the kernel's summation
order (pixels into chunks, chunks into runs, runs into the total for the
sum over W; a warp's 4 rows by shuffles, warps, then bands in order for
the sum over H), held to a float64 sum at W = 4097 and H = 1025 (rtol
1e-5, atol 1e-4, as the card check); the wrapper's checks; and the
probe's readers of nvcc's and cuobjdump's output.
"""
import numpy as np
import pytest
import torch

from stc_unet_tpu_torch.ops import dual_pools as tdp
from tests.fixtures.torch_threads import torch_threads  # noqa: F401


def _plan(vec, width, warps, bands, tiles, blocks, combine, n=None, w=None):
    tile = 8 * width
    last = combine == 'last'
    return dict(vec=vec, width=width, warps=warps, bands=bands, tiles=tiles,
                blocks=blocks, chunk=min(1024 // tile, 32), run=32,
                combine=combine,
                cluster=bands if combine == 'cluster' else 0,
                scratch=n * tiles * bands * w * tile if last else 0,
                counters=n * tiles if last else 0)


@pytest.mark.parametrize('shape,itemsize,aligned,want', [
    # the probe's four B=14 bf16 stages: 16-byte vectors of 8 bfloat16,
    # tiles of 64 channels; 32 rows take 8 warps; 128 and 256 rows are 2
    # and 4 bands of 64, added in a cluster
    ((14, 32, 32, 1024), 2, True, _plan(1, 8, 8, 1, 16, 224, 'one_band')),
    ((14, 64, 64, 512), 2, True, _plan(1, 8, 16, 1, 8, 112, 'one_band')),
    ((14, 128, 128, 256), 2, True, _plan(1, 8, 16, 2, 4, 112, 'cluster')),
    ((14, 256, 256, 128), 2, True, _plan(1, 8, 16, 4, 2, 112, 'cluster')),
    # f32: vectors of 4 floats, tiles of 32 channels, chunks of 32 pixels
    ((14, 256, 256, 128), 4, True, _plan(1, 4, 16, 4, 4, 224, 'cluster')),
    # C of 13, 24 and 40 (no multiple of a tile): one element a lane,
    # tiles of 8 channels
    ((2, 5, 7, 13), 4, True, _plan(0, 1, 2, 1, 2, 4, 'one_band')),
    ((3, 37, 53, 24), 2, True, _plan(0, 1, 10, 1, 3, 9, 'one_band')),
    ((1, 130, 71, 40), 4, True, _plan(0, 1, 16, 3, 5, 15, 'cluster')),
    # a tile's C, unaligned: the scalar path
    ((2, 64, 3, 1024), 2, False, _plan(0, 1, 16, 1, 128, 256, 'one_band')),
    # H of 1, 63, 64 and 65; 513 and 1025 are 9 and 17 bands, past a
    # cluster: the last band block adds them
    ((3, 1, 5, 64), 2, True, _plan(1, 8, 1, 1, 1, 3, 'one_band')),
    ((1, 63, 7, 64), 2, True, _plan(1, 8, 16, 1, 1, 1, 'one_band')),
    ((2, 64, 9, 64), 2, True, _plan(1, 8, 16, 1, 1, 2, 'one_band')),
    ((1, 65, 7, 64), 2, True, _plan(1, 8, 16, 2, 1, 2, 'cluster')),
    ((1, 512, 3, 32), 4, True, _plan(1, 4, 16, 8, 1, 8, 'cluster')),
    ((1, 513, 3, 64), 2, True, _plan(1, 8, 16, 9, 1, 9, 'last', 1, 3)),
    ((1, 1025, 2, 64), 4, True, _plan(1, 4, 16, 17, 2, 34, 'last', 1, 2)),
    # W of 1, 1753 (past the old limit), 2049 and 4097: no limit on W
    ((2, 5, 1, 64), 2, True, _plan(1, 8, 2, 1, 1, 2, 'one_band')),
    ((1, 5, 1753, 64), 2, True, _plan(1, 8, 2, 1, 1, 1, 'one_band')),
    ((1, 70, 2049, 32), 4, True, _plan(1, 4, 16, 2, 1, 2, 'cluster')),
    ((1, 9, 4097, 64), 2, True, _plan(1, 8, 3, 1, 1, 1, 'one_band')),
    # N of 65536 (past the old grid.y limit) on a 1-D grid
    ((65536, 2, 3, 33), 4, True, _plan(0, 1, 1, 1, 5, 327680, 'one_band')),
])
def test_dual_plan_over_stages_and_edges(shape, itemsize, aligned, want):
    """``dual_plan`` picks vectors from the shape and alignment alone, a
    block of up to 16 warps a band of 4 rows a warp (at most 64 rows),
    clusters for 2 to 8 bands and the last band block past 8."""
    plan = tdp.dual_plan(shape, itemsize, aligned)
    assert plan == want
    n, h, w, c = shape
    assert plan['warps'] * 4 * plan['bands'] >= h
    assert plan['warps'] * 4 * (plan['bands'] - 1) < h
    assert plan['warps'] * 4 <= 64
    assert plan['tiles'] * 8 * plan['width'] >= c


def test_dual_plan_has_no_n_or_w_limit_below_the_grid():
    """N and W take any size up to a grid of 2^31 - 1 blocks; past it the
    plan raises."""
    big_n = tdp.dual_plan((2 ** 31 - 1, 1, 3, 8), 2, True)
    assert big_n['blocks'] == 2 ** 31 - 1 and big_n['vec'] == 0
    big_w = tdp.dual_plan((1, 1, 10 ** 7, 64), 2, True)
    assert big_w['blocks'] == 1 and big_w['vec'] == 1
    assert tdp.dual_plan((2 ** 24, 64, 3, 128), 4, True)['blocks'] == 2 ** 26
    with pytest.raises(ValueError, match='2\\^31 - 1'):
        tdp.dual_plan((2 ** 31, 1, 3, 8), 2, True)
    with pytest.raises(ValueError, match='2\\^31 - 1'):
        tdp.dual_plan((2 ** 29, 65, 3, 128), 2, True)


@pytest.mark.parametrize('shape,combine', [
    ((1, 64, 3, 64), 'cluster'), ((1, 64, 3, 64), 'last'),
    ((1, 65, 3, 64), 'one_band'), ((1, 513, 3, 64), 'cluster'),
    ((1, 65, 3, 64), 'atomics')])
def test_dual_plan_refuses_a_combine_the_shape_does_not_take(shape, combine):
    """One band is stored as it is; 2 to 8 bands take a cluster or the
    last block; past 8 only the last block."""
    with pytest.raises(ValueError, match='does not take'):
        tdp.dual_plan(shape, 2, True, combine)


def test_dual_plan_takes_either_way_for_two_to_eight_bands():
    """The probe times the way the plan does not take: the last block
    adds 2 to 8 bands from a scratch of (N * tiles, bands, W, tile) f32."""
    plan = tdp.dual_plan((14, 256, 256, 128), 2, True, 'last')
    assert plan['combine'] == 'last' and plan['cluster'] == 0
    assert plan['scratch'] == 14 * 2 * 4 * 256 * 64
    assert plan['counters'] == 14 * 2


# -- the kernel's summation order -------------------------------------------

def _model(x, plan):
    """P's sums of x (N, H, W, C) float32 in the kernel's order, each
    addition rounded to f32: the sum over W pixel by pixel into a chunk of
    ``chunk`` pixels, chunks into a run of ``run`` chunks, runs into the
    total; the sum over H as (r0 + r2) + (r1 + r3) over a warp's 4 rows,
    then the warps of a band in order, then the bands in order."""
    f32 = np.float32
    n, h, w, c = x.shape
    ck, rn = plan['chunk'], plan['run']
    chunk = np.zeros((n, h, c), f32)
    run, total = chunk.copy(), chunk.copy()
    chunks = 0
    for w0 in range(0, w, ck):
        for p in range(w0, min(w0 + ck, w)):
            chunk = chunk + x[:, :, p]
        run, chunk = run + chunk, np.zeros_like(chunk)
        chunks += 1
        if chunks == rn or w0 + ck >= w:
            total, run, chunks = total + run, np.zeros_like(run), 0
    warps, bands = plan['warps'], plan['bands']
    rows = np.zeros((n, bands * warps * 4, w, c), f32)
    rows[:, :h] = x
    r = rows.reshape(n, bands, warps, 4, w, c)
    warp = (r[:, :, :, 0] + r[:, :, :, 2]) + (r[:, :, :, 1] + r[:, :, :, 3])
    band = np.zeros((n, bands, w, c), f32)
    for q in range(warps):
        band = band + warp[:, :, q]
    col = np.zeros((n, w, c), f32)
    for b in range(bands):
        col = col + band[:, b]
    return total, col


def _chains(plan, h, w):
    """The longest chains of f32 additions in P's order: the sum over W
    (chunk, run, total) and the sum over H (warps, bands)."""
    ck, rn = plan['chunk'], plan['run']
    return (min(ck, w), min(rn, -(-w // ck)), -(-w // (ck * rn)),
            plan['warps'], plan['bands'])


@pytest.mark.parametrize('shape,itemsize', [
    ((1, 3, 4097, 8), 4), ((1, 2, 4097, 64), 2), ((1, 1025, 3, 8), 4),
    ((1, 1025, 2, 64), 2), ((2, 130, 71, 13), 4)])
def test_summation_order_holds_to_a_float64_sum(shape, itemsize):
    """The model of P's order, in f32, against float64 sums at W of 4097
    and H of 1025: within the card check's rtol 1e-5 and atol 1e-4, and
    no chain of f32 additions longer than 64 terms."""
    n, h, w, c = shape
    x = np.random.RandomState(11).rand(*shape).astype(np.float32)
    plan = tdp.dual_plan(shape, itemsize, True)
    assert max(_chains(plan, h, w)) <= 64
    got_w, got_h = _model(x, plan)
    assert got_w.dtype == got_h.dtype == np.float32
    np.testing.assert_allclose(got_w, x.astype(np.float64).sum(2),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_h, x.astype(np.float64).sum(1),
                               rtol=1e-5, atol=1e-4)


# -- the wrapper -------------------------------------------------------------

def test_cpu_path_is_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(
        np.random.RandomState(13).rand(2, 9, 5, 13).astype(np.float32))
    before = tdp.dual_pools.launches
    sh, sw = tdp.dual_pools(x.to(torch.bfloat16))
    eh, ew = tdp.dual_pools_reference(x.to(torch.bfloat16))
    assert torch.equal(sh, eh) and torch.equal(sw, ew)
    assert sh.dtype == sw.dtype == torch.float32
    assert tdp.dual_pools.launches == before


@pytest.mark.parametrize('bad', [
    torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, 5, dtype=torch.float16),
    torch.zeros(2, 3, 4, 5).transpose(1, 2), torch.zeros(2, 0, 4, 5)])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The checks come before the library is loaded, so they run here."""
    with pytest.raises(ValueError):
        tdp._dual_pools_kernel(bad)


# -- the probe's readers -----------------------------------------------------

def test_probe_reads_ptxas_and_sass_of_each_build():
    """Registers and spills of each build of P from nvcc's ptxas lines,
    its global loads from cuobjdump, named by type, width and the way its
    bands meet; other kernels are left out."""
    from stc_unet_tpu_torch.tools import probe_coordatt as pc
    pre = '_ZN46_GLOBAL__N__daeb70b7_13_dual_pools_cu_9f9dfffd9dual_band'
    bf16 = f'{pre}I13__nv_bfloat16Li8ELi1EEEvPKT_PfS5_S5_Pjiiiii'
    f32 = f'{pre}IfLi1ELi2EEEvPKT_PfS4_S4_Pjiiiii'
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{bf16}' for 'sm_90a'",
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 128 registers, used 1 barriers',
        f"ptxas info    : Compiling entry function '{f32}' for 'sm_90a'",
        '    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads',
        'ptxas info    : Used 64 registers, used 1 barriers, 16 bytes smem',
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        'ptxas info    : Used 8 registers'])
    assert pc.ptxas_usage(log) == {
        'dual_band<bf16, 8, cluster>': {'spill_bytes': 0, 'registers': 128},
        'dual_band<f32, 1, last>': {'spill_bytes': 4, 'registers': 64}}
    sass = '\n'.join([
        f'        Function : {bf16}',
        '        /*0100*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;',
        '        /*0110*/  LDG.E.128.CONSTANT R8, desc[UR6][R2.64+0x80] ;',
        '        /*0120*/  LDS.128 R12, [R3] ;',
        f'        Function : {f32}',
        '        /*0100*/  LDG.E.CONSTANT R4, desc[UR6][R2.64] ;',
        '        /*0110*/  LDG.E.128.STRONG.GPU R8, desc[UR6][R2.64] ;',
        '        Function : _Z5otherv',
        '        /*0100*/  LDG.E.128 R4, desc[UR6][R2.64] ;'])
    loads = pc.sass_loads(sass)
    assert loads == {
        'dual_band<bf16, 8, cluster>': {'LDG.E.128.CONSTANT': 2},
        'dual_band<f32, 1, last>': {'LDG.E.CONSTANT': 1,
                                    'LDG.E.128.STRONG.GPU': 1}}
    # twelve builds, each vector build with 128-bit loads, pass
    full = {f'dual_band<{t}, {v}, {way}>': {
        'LDG.E.128.CONSTANT' if v > 1 else 'LDG.E.CONSTANT': 16}
        for t, vec in (('f32', 4), ('bf16', 8)) for v in (1, vec)
        for way in ('one_band', 'cluster', 'last')}
    assert pc.vector_builds_load_128(full)
    assert not pc.vector_builds_load_128(loads)
    full['dual_band<bf16, 8, last>'] = {'LDG.E.CONSTANT': 64}
    assert not pc.vector_builds_load_128(full)
