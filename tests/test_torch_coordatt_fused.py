"""The port's CoordAtt kernels (``stc_unet_tpu_torch/ops/coordatt_fused.py``)
against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain PyTorch versions; the
JAX kernels run in interpret mode. Inputs are made with numpy from a seed.
Tolerances: the strip sums and the backward's sums of products are f32
sums taken in another order (rtol 1e-5, atol 1e-5); the gate add is the
same two roundings on both sides (rtol 1e-6). The CUDA kernels are held to
the plain versions on the card in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.ops import coordatt_fused as jfused
from stc_unet_tpu_torch.ops import coordatt_fused as tfused

SHAPES = [(2, 8, 16, 24), (1, 16, 8, 128), (3, 4, 4, 8), (3, 37, 53, 24)]


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gates(n, h, w, c, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, c).astype(np.float32),
            rng.rand(n, w, c).astype(np.float32))


@pytest.mark.parametrize('shape', SHAPES)
def test_strip_pools_matches_jax_kernel(shape):
    x = _x(shape)
    jh, jw = jfused.strip_pools(jnp.asarray(x), True)
    th, tw = tfused.strip_pools(torch.from_numpy(x))
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


@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_gate_dots_reference_matches_jax_kernel(shape):
    """K2b's plain version against the JAX backward of gate_add, which runs
    ``_gate_dots_call`` in interpret mode."""
    x = _x(shape)
    do = _x(shape, seed=5)
    a_h, a_w = _gates(*shape)
    _, vjp = jax.vjp(lambda *a: jfused.gate_add(*a, True), jnp.asarray(x),
                     jnp.asarray(a_h), jnp.asarray(a_w))
    jdx, jdh, jdw = vjp(jnp.asarray(do))
    dh, dw = tfused.gate_dots(torch.from_numpy(do), torch.from_numpy(a_h),
                              torch.from_numpy(a_w))
    assert dh.dtype == dw.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jdx), do)
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
