"""The port's CoordAtt kernels (``stc_unet_tpu_torch/ops/coordatt_fused.py``)
against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain PyTorch versions; the
JAX kernels run in interpret mode. Inputs are made with numpy from a seed
(bfloat16 inputs are the f32 draws rounded to nearest on both sides).
Tolerances: the strip sums and the backward's sums of products are f32
sums taken in another order (rtol 1e-5, atol 1e-5); the gate add is the
same two roundings on both sides (rtol 1e-6). The CUDA kernels are held to
the plain versions on the card in ``test_torch_kernels_cuda.py``; here the
launch plan of K1 and K2b (``strip_plan``) and the ablation probe's parts
that need no card are checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.ops import coordatt_fused as jfused
from stc_unet_tpu_torch.ops import coordatt_fused as tfused
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

SHAPES = [(2, 8, 16, 24), (1, 16, 8, 128), (3, 4, 4, 8), (3, 37, 53, 24)]
# the f32 cases keep their ids; each shape also runs in bfloat16
BY_DTYPE = ([pytest.param(s, 'float32', id=f'shape{i}')
             for i, s in enumerate(SHAPES)] +
            [pytest.param(s, 'bfloat16', id=f'shape{i}-bf16')
             for i, s in enumerate(SHAPES)])


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gates(n, h, w, c, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, c).astype(np.float32),
            rng.rand(n, w, c).astype(np.float32))


def _both(a, dtype):
    """a (f32 numpy) as a JAX and a torch array of dtype."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize('shape,dtype', BY_DTYPE)
def test_strip_pools_matches_jax_kernel(shape, dtype):
    jx, tx = _both(_x(shape), dtype)
    jh, jw = jfused.strip_pools(jx, True)
    th, tw = tfused.strip_pools(tx)
    assert th.dtype == tw.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_gate_add_matches_jax_kernel(shape):
    x = _x(shape)
    a_h, a_w = _gates(*shape)
    ref = jfused.gate_add(jnp.asarray(x), jnp.asarray(a_h), jnp.asarray(a_w),
                          True)
    out = tfused.gate_add(torch.from_numpy(x), torch.from_numpy(a_h),
                          torch.from_numpy(a_w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('shape,dtype', [
    p for p in BY_DTYPE if p.id.split('-')[0] in ('shape0', 'shape1',
                                                  'shape3')])
def test_gate_dots_reference_matches_jax_kernel(shape, dtype):
    """K2b's plain version against the JAX kernel in interpret mode: in f32
    through the JAX backward of gate_add, which runs ``_gate_dots_call``;
    in bfloat16 against ``_gate_dots_call`` itself, whose sums are f32 (the
    backward casts them to bfloat16 once)."""
    x = _x(shape)
    do = _x(shape, seed=5)
    a_h, a_w = _gates(*shape)
    (jx, tx), (jdo, tdo), (jah, tah), (jaw, taw) = (
        _both(a, dtype) for a in (x, do, a_h, a_w))
    dh, dw = tfused.gate_dots(tdo, tah, taw)
    assert dh.dtype == dw.dtype == torch.float32
    if dtype == 'float32':
        _, vjp = jax.vjp(lambda *a: jfused.gate_add(*a, True), jx, jah, jaw)
        jdx, jdh, jdw = vjp(jdo)
        np.testing.assert_array_equal(np.asarray(jdx), do)
    else:
        jdh, jdw = jfused._gate_dots_call(jdo, jah, jaw, True)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


def test_gate_add_autograd_on_cpu_matches_jax_vjp():
    """The CPU autograd of the port's gate_add (its plain version) against
    ``jax.vjp`` of the JAX kernel in interpret mode."""
    shape = SHAPES[3]
    x, do = _x(shape), _x(shape, seed=6)
    a_h, a_w = _gates(*shape, seed=7)
    _, vjp = jax.vjp(lambda *a: jfused.gate_add(*a, True), jnp.asarray(x),
                     jnp.asarray(a_h), jnp.asarray(a_w))
    ref = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, a_h, a_w)]
    tfused.gate_add(*leaves).backward(torch.from_numpy(do))
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)


def test_cpu_path_counts_no_launch():
    x = torch.from_numpy(_x((1, 4, 4, 8)))
    a_h, a_w = (torch.from_numpy(a) for a in _gates(1, 4, 4, 8))
    counts = (tfused.strip_pools, tfused.gate_add, tfused.gate_dots)
    before = [f.launches for f in counts]
    tfused.strip_pools(x)
    tfused.gate_add(x, a_h, a_w)
    tfused.gate_dots(x, a_h, a_w)
    assert [f.launches for f in counts] == before


@pytest.mark.parametrize('bad', ['ndim', 'dtype', 'layout'])
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros(2, 4, 4, 8)
    if bad == 'ndim':
        x = x[0]
    elif bad == 'dtype':
        x = x.half()
    else:
        x = x.permute(0, 2, 1, 3)
    with pytest.raises((ValueError, TypeError)):
        tfused._strip_pools_kernel(x)
    with pytest.raises((ValueError, TypeError)):
        tfused._gate_add_kernel(x, torch.zeros(2, 4, 8), torch.zeros(2, 4, 8))
    with pytest.raises((ValueError, TypeError)):
        tfused._gate_dots_kernel(x, torch.zeros(2, 4, 8),
                                 torch.zeros(2, 4, 8))


def test_coordatt_module_matches_jax():
    """The port's CoordAtt is the JAX module's eval ``residual=True`` (the
    Up-stage use); weights carried by ``jax_to_torch_state``."""
    from stc_unet_tpu.models.decode_heads.unet_head import CoordAtt as JCA
    from stc_unet_tpu_torch.models.decode_heads.unet_head import \
        CoordAtt as TCA
    from stc_unet_tpu_torch.utils import jax_to_torch_state

    n, h, w, c = 2, 8, 12, 32
    x = _x((n, h, w, c), seed=3)
    variables = JCA(c).init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(4)
    mip = max(8, c // 4)
    variables = {
        'params': jax.tree_util.tree_map(np.asarray,
                                         dict(variables['params'])),
        'batch_stats': {'bn1': {
            'mean': rng.uniform(-0.2, 0.2, mip).astype(np.float32),
            'var': rng.uniform(0.8, 1.2, mip).astype(np.float32)}}}
    ref = JCA(c).apply(variables, jnp.asarray(x), residual=True)

    mod = TCA(c, c).eval()
    mod.load_state_dict(jax_to_torch_state(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = mod(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)


# -- the launch plan of K1 and K2b -------------------------------------------

@pytest.mark.parametrize('shape,itemsize,aligned,want', [
    # the train step's four bf16 Up stages at B=8: vectors, bands of 64
    ((8, 64, 64, 1024), 2, True, dict(vec=1, width=8, warps=16, bands=1,
                                      tiles=16, blocks=128)),
    ((8, 512, 512, 128), 2, True, dict(vec=1, width=8, warps=16, bands=8,
                                       tiles=2, blocks=128)),
    # the slide batch's f32 tiles: 32 rows take 8 warps
    ((126, 32, 32, 1024), 4, True, dict(vec=1, width=4, warps=8, bands=1,
                                        tiles=32, blocks=4032)),
    ((126, 256, 256, 128), 4, True, dict(vec=1, width=4, warps=16, bands=4,
                                         tiles=4, blocks=2016)),
    # odd C (not a multiple of the 64- or 32-channel tile): one element a
    # lane, tiles of 8 channels
    ((3, 37, 53, 24), 2, True, dict(vec=0, width=1, warps=10, bands=1,
                                    tiles=3, blocks=9)),
    ((2, 19, 23, 13), 4, True, dict(vec=0, width=1, warps=5, bands=1,
                                    tiles=2, blocks=4)),
    ((1, 130, 71, 40), 4, True, dict(vec=0, width=1, warps=16, bands=3,
                                     tiles=5, blocks=15)),
    # a tile's C, unaligned (a tensor 2 bytes off 16): the scalar path
    ((2, 64, 3, 1024), 2, False, dict(vec=0, width=1, warps=16, bands=1,
                                      tiles=128, blocks=256)),
    # H of 1, 65, 513 and 1025 (past 8 bands), W of 2049
    ((2, 1, 5, 64), 2, True, dict(vec=1, width=8, warps=1, bands=1,
                                  tiles=1, blocks=2)),
    ((1, 65, 7, 64), 2, True, dict(vec=1, width=8, warps=16, bands=2,
                                   tiles=1, blocks=2)),
    ((1, 513, 3, 64), 4, True, dict(vec=1, width=4, warps=16, bands=9,
                                    tiles=2, blocks=18)),
    ((1, 1025, 2, 32), 4, True, dict(vec=1, width=4, warps=16, bands=17,
                                     tiles=1, blocks=17)),
    ((1, 5, 2049, 64), 2, True, dict(vec=1, width=8, warps=2, bands=1,
                                     tiles=1, blocks=1)),
])
def test_strip_plan_over_odd_and_edge_shapes(shape, itemsize, aligned, want):
    """``strip_plan`` picks vectors from the shape and alignment alone, a
    block of up to 16 warps a band of 4 rows a warp, and a scratch for the
    bands' column sums only where H has more than one band."""
    plan = tfused.strip_plan(shape, itemsize, aligned)
    n, _, w, c = shape
    assert plan == dict(want, scratch=(n, want['bands'], w, c)
                        if want['bands'] > 1 else None)
    assert plan['warps'] * 4 * plan['bands'] >= shape[1]
    assert plan['tiles'] * 8 * plan['width'] >= c


# -- the ablation probe of K1 and K2b ----------------------------------------

def test_strip_pools_probe_needs_a_card(monkeypatch, capsys):
    """The ablation probe builds and times on the card only: without CUDA
    it exits 1 and prints no record."""
    from stc_unet_tpu_torch.tools import probe_strip_pools
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert probe_strip_pools.main([]) == 1
    assert capsys.readouterr().out == ''
    with pytest.raises(RuntimeError, match='CUDA card'):
        probe_strip_pools.probe()


@pytest.mark.parametrize('variant', ['base', 'scalar', 'group_2', 'group_4',
                                     'chunk_512', 'warps_8', 'scalar_bands',
                                     'no_bands'])
def test_strip_pools_probe_edits_apply_to_the_source(variant):
    """Each variant's edits match the kernel source as often as they
    should, only the variants that change the plan or the source leave it
    or change it, and every edit keeps braces and parentheses balanced."""
    from stc_unet_tpu_torch.ops import _build
    from stc_unet_tpu_torch.tools import probe_strip_pools
    source = (_build.SRC_DIR / 'coordatt_fused.cu').read_text()
    edited = probe_strip_pools.variant_source(variant, source)
    assert (edited == source) == (not probe_strip_pools.EDITS[variant])
    for a, b in ('{}', '()'):
        assert edited.count(a) - edited.count(b) == \
            source.count(a) - source.count(b)


def test_strip_pools_probe_reads_ptxas_and_sass():
    """The probe's registers and spills of each K1/K2b build, from nvcc's
    ptxas lines, and the load instructions of each in its SASS, named by
    type, vector width and kernel; other kernels are left out."""
    from stc_unet_tpu_torch.tools import probe_strip_pools
    k1 = ('_ZN50_GLOBAL__N__f07fce08_17_coordatt_fused_cu_8f9c58f110strip_'
          'bandI13__nv_bfloat16Li8ELb0EEEvPKT_S4_S4_PfS5_iiiii')
    k2b = ('_ZN50_GLOBAL__N__f07fce08_17_coordatt_fused_cu_8f9c58f110strip_'
           'bandIfLi1ELb1EEEvPKT_S3_S3_PfS4_iiiii')
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{k1}' for 'sm_90a'",
        f'ptxas info    : Function properties for {k1}',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 120 registers, used 1 barriers',
        f"ptxas info    : Compiling entry function '{k2b}' for 'sm_90a'",
        '    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads',
        'ptxas info    : Used 56 registers, used 1 barriers',
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__f07fce08_"
        "17_coordatt_fused_cu_8f9c58f111strip_bandsILi4EEvPKfPflil' for "
        "'sm_90a'",
        'ptxas info    : Used 20 registers, used 0 barriers'])
    assert probe_strip_pools.ptxas_usage(log) == {
        'strip_band<bf16, 8, pools>': {'spill_bytes': 0, 'registers': 120},
        'strip_band<f32, 1, dots>': {'spill_bytes': 4, 'registers': 56}}
    sass = '\n'.join([
        f'        Function : {k1}',
        '        /*0100*/  LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;',
        '        /*0110*/  LDG.E.128.CONSTANT R8, desc[UR6][R2.64+0x80] ;',
        '        /*0120*/  LDS.128 R12, [R3] ;',
        f'        Function : {k2b}',
        '        /*0100*/  LDG.E.CONSTANT R4, desc[UR6][R2.64] ;',
        '        Function : _ZN50_GLOBAL__N_111strip_bandsILi4EEvPKfPflil',
        '        /*0100*/  LDG.E.128 R4, desc[UR6][R2.64] ;'])
    assert probe_strip_pools.vector_loads(sass) == {
        'strip_band<bf16, 8, pools>': {'LDG.E.128.CONSTANT': 2},
        'strip_band<f32, 1, dots>': {'LDG.E.CONSTANT': 1}}
