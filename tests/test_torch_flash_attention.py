"""The port's flash attention (kernel L: ``ops/flash_attention.py``) and the
STC transformer's flash path, against JAX on the CPU.

The JAX side is the library's Pallas flash attention
(``jax.experimental.pallas.ops.tpu.flash_attention``), run in interpret
mode inside ``pltpu.force_tpu_interpret_mode()`` (on the CPU it refuses to
run otherwise). Its default blocks are 128, so it takes only lengths that
are multiples of 128; at other lengths the port's plain versions are held
to an einsum softmax in JAX and its ``jax.vjp``. A flax model that
holds the flash call is initialised outside the interpret context (the
init traces the call too) with the flag off, which changes no parameter.
On the CPU the port's wrappers compute their plain versions; the kernels
are held to those on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

Inputs come from numpy with a seed. Tolerances, f32: rtol 1e-5 and atol
1e-5 of the largest value for the attention core and its gradients (sums
in another order); the modules as in ``tests/test_torch_stc_unet.py`` and
``tests/test_torch_train_step.py``; bf16 flows to a few bf16 ulps (rtol and
atol 2^-5), as ``test_mha_dtype_flow_matches_jax``.
"""
import functools
import math
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from stc_unet_tpu.models.backbones.unet_backbone import \
    MultiheadAttention as JMHA
from stc_unet_tpu.models.backbones.unet_backbone import \
    TransformerBlock as JBlock
from stc_unet_tpu_torch.models.backbones.unet_backbone import (
    MultiheadAttention, TransformerBlock, UnetBackbone)
from stc_unet_tpu_torch.ops import dual_pools as tdp
from stc_unet_tpu_torch.ops.flash_attention import (
    _shape_args, flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_forward,
    flash_attention_reference)
from stc_unet_tpu_torch.utils import jax_to_torch_state

TOOLS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), 'tools')


def _inputs(shape, seed=0, lk=None):
    """q, k, v, do (N, heads, L, d) f32 from a seed; k and v of length
    ``lk`` when given."""
    rng = np.random.RandomState(seed)
    kv = shape[:2] + (lk or shape[2], shape[3])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*kv).astype(np.float32),
            rng.randn(*kv).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _library(shape):
    """The library's o, (l, m) residuals and jax.vjp gradients at shape,
    in interpret mode."""
    q, k, v, do = (jnp.asarray(a) for a in _inputs(shape))
    scale = 1.0 / math.sqrt(shape[-1])
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
            a, b, c, sm_scale=scale), q, k, v)
        grads = vjp(do)
        _, l, m = jfa._flash_attention(
            q, k, v, None, None, True, False, scale,
            jfa.BlockSizes.get_default(*shape[:3], shape[2], shape[3]),
            False)
    return (np.asarray(o), np.asarray(l), np.asarray(m),
            [np.asarray(g) for g in grads])


SHAPES = [(1, 2, 128, 8), (2, 2, 256, 32), (1, 2, 128, 256)]


@pytest.mark.parametrize('shape', SHAPES)
def test_flash_attention_matches_the_library(shape):
    """The port's flash_attention and its autograd gradients against the
    library's flash_attention and jax.vjp, in interpret mode; lse against
    the library's residuals, m + log l."""
    o_ref, l_ref, m_ref, grads_ref = _library(shape)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    scale = 1.0 / math.sqrt(shape[-1])
    o = flash_attention(*leaves, sm_scale=scale)
    o.backward(do)
    assert o.shape == shape and o.dtype == torch.float32
    _close(o.detach(), o_ref)
    for leaf, g in zip(leaves, grads_ref):
        _close(leaf.grad, g)
    _, lse = flash_attention_forward(q, k, v, scale)
    np.testing.assert_allclose(lse.numpy(), m_ref + np.log(l_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES[:2])
def test_plain_backward_matches_jax_vjp(shape):
    """flash_attention_backward_reference and the two plain halves (Ldkv's
    dk, dv and Ldq's dq, from di = sum o*do) against jax.vjp of the
    library's kernels."""
    o_ref, _, _, (dq_ref, dk_ref, dv_ref) = _library(shape)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape))
    scale = 1.0 / math.sqrt(shape[-1])
    o, lse = flash_attention_reference(q, k, v, scale)
    dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                    scale)
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, want)
    di = (o * do).sum(-1)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert torch.equal(flash_attention_bwd_dq(q, k, v, lse, do, di, scale),
                       dq)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_attention_backward(q, k, v, o, lse, do, scale), (dq, dk, dv)))


@pytest.mark.parametrize('lq,lk,d', [(16, 16, 8), (100, 100, 64),
                                     (100, 16, 256), (16, 100, 32)])
def test_plain_versions_at_lengths_the_library_refuses(lq, lk, d):
    """L = 16 and 100 (the library wants multiples of 128): the plain
    versions against the einsum form of the library's ``mha_reference``
    and its jax.vjp (``mha_reference``'s own VJP takes no sm_scale)."""
    q, k, v, do = _inputs((2, 2, lq, d), seed=1, lk=lk)
    scale = 1.0 / math.sqrt(d)

    def reference(a, b, c):
        s = jnp.einsum('nhqd,nhkd->nhqk', a, b) * scale
        return jnp.einsum('nhqk,nhkd->nhqd', jax.nn.softmax(s, -1), c)

    o_ref, vjp = jax.vjp(reference, *(jnp.asarray(a) for a in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_reference(tq, tk, tv, scale)
    _close(o, o_ref)
    s = np.einsum('nhqd,nhkd->nhqk', q, k) * scale
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(s.astype(np.float64)).sum(-1)),
        rtol=1e-5, atol=1e-5)
    for got, want in zip(flash_attention_backward_reference(
            tq, tk, tv, o, lse, tdo, scale), grads_ref):
        _close(got, want)


def test_cpu_wrappers_take_strided_views_and_launch_nothing():
    """The model's q, k, v are views of (N, L, C) rows; on the CPU the
    wrappers give their plain versions and count no launch."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 40, 3 * 32).astype(np.float32))
    q, k, v = (x[..., i * 32:(i + 1) * 32].reshape(2, 40, 2, 16)
               .transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    want = flash_attention_reference(*(t.contiguous() for t in (q, k, v)),
                                     0.25)[0]
    torch.testing.assert_close(flash_attention(q, k, v, 0.25), want,
                               rtol=1e-6, atol=1e-6)
    assert (flash_attention_forward.launches, flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (0, 0, 0)


def test_kernel_arguments_are_checked():
    """What the kernels do not take raises before a launch: another dtype,
    a head wider than 256, N·heads times the tiles of 32 rows past a
    grid's 2³¹ - 1 blocks, a strided last axis, mismatched shapes."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(TypeError, match='float32'):
        _shape_args(q.bfloat16(), q.bfloat16(), q.bfloat16())
    wide = torch.zeros(1, 2, 8, 300)
    with pytest.raises(ValueError, match='no kernel'):
        _shape_args(wide, wide, wide)
    one = torch.zeros(1, 1, 1, 1)
    for shape in ((2 ** 31, 1, 1, 1), (2 ** 16, 1, 2 ** 20, 1)):
        big = one.expand(shape)
        with pytest.raises(ValueError, match='no kernel'):
            _shape_args(big, big, big)
    strided = torch.zeros(1, 2, 8, 32)[..., ::2]
    with pytest.raises(ValueError, match='contiguous last axis'):
        _shape_args(strided, strided, strided)
    with pytest.raises(ValueError, match='k and v'):
        _shape_args(q, q, torch.zeros(1, 2, 9, 16))
    ptrs, shape = _shape_args(q, torch.zeros(1, 2, 5, 16),
                              torch.zeros(1, 2, 5, 16))
    assert shape == (1, 2, 8, 5, 16) and len(ptrs) == 12


@pytest.mark.parametrize('kernel', ['flash N·heads', 'window W',
                                    'coordatt N'])
def test_launch_arguments_pass_the_old_grid_limit(kernel):
    """N·heads (Lf, Ldkv, Ldq), W windows (K3f, K3b) and N images (K1,
    K2, K2b) of 65536, one past the 65535 a grid's y or z may hold, are
    taken: each now runs on grid.x, or in chunks of windows."""
    if kernel == 'flash N·heads':
        q = torch.zeros(32768, 2, 3, 1)
        assert _shape_args(q, q, q)[1] == (32768, 2, 3, 3, 1)
    elif kernel == 'window W':
        from stc_unet_tpu_torch.ops.window_attention import _kernel_args
        q = torch.zeros(65536, 4, 2)
        shape, _ = _kernel_args(q, q, q, torch.zeros(4, 4),
                                torch.zeros(1, dtype=torch.int64), 1, 0.5,
                                0.0)
        assert shape == (0, 65536, 4, 1, 2, 2)
    else:
        from stc_unet_tpu_torch.ops.coordatt_fused import _check_x
        _check_x(torch.zeros(65536, 1, 2, 1))


# -- the modules ----------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(variables):
    """``jax_to_torch_state`` of one module's variables, under a name that
    is then cut off (the bridge names a bare top-level leaf '.name')."""
    state = jax_to_torch_state({k: {'m': v} for k, v in variables.items()})
    return {k[len('m.'):]: v for k, v in state.items()}


def _mha_params(c, heads, seed=0):
    rng = np.random.RandomState(seed)
    return {'in_proj_weight': (rng.randn(3 * c, c) * 0.3).astype(np.float32),
            'in_proj_bias': (rng.randn(3 * c) * 0.1).astype(np.float32),
            'out_proj': {'linear': {
                'kernel': (rng.randn(c, c) * 0.3).astype(np.float32),
                'bias': (rng.randn(c) * 0.1).astype(np.float32)}}}


@pytest.mark.parametrize('dtype,train', [('float32', False),
                                         ('bfloat16', False),
                                         ('bfloat16', True)])
def test_mha_flash_matches_jax(dtype, train):
    """MultiheadAttention(use_flash=True) against the JAX module's flash
    path: the output and the input gradients, in the eval and train dtype
    flows (a bf16 input: eval promotes to f32, training stays bf16)."""
    c, heads, n, length = 16, 2, 2, 128
    rng = np.random.RandomState(3)
    q, k, v, do = (rng.randn(n, length, c).astype(np.float32)
                   for _ in range(4))
    params = _mha_params(c, heads)
    jdt = jnp.dtype(dtype)
    jm = JMHA(embed_dim=c, num_heads=heads, use_flash=True)
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        jout, vjp = jax.vjp(lambda *a: jm.apply({'params': params}, *a,
                                                train=train), *args)
        jgrads = vjp(jnp.asarray(do, jout.dtype))
    tm = MultiheadAttention(c, heads, use_flash=True).train(train)
    tm.load_state_dict(_state({'params': params}), strict=True)
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (q, k, v)]
    tout = tm(*leaves)
    assert str(tout.dtype) == f'torch.{jout.dtype}'
    tout.backward(torch.from_numpy(do).to(tout.dtype))
    tol = 1e-5 if dtype == 'float32' else 2 ** -5
    _close(tout.detach().float(), jout, rtol=tol)
    for leaf, g in zip(leaves, jgrads):
        assert leaf.grad.dtype == tdt
        _close(leaf.grad.float(), g, rtol=tol)


def test_flash_and_einsum_paths_share_parameters():
    """The flag has no parameters: one state dict loads into both variants
    of the full backbone with strict=True, and at a width where
    sqrt(hd) rounds to itself in f32 the two paths agree: rtol 1e-4, atol
    1e-5 of the largest value, as two forms of the softmax round apart
    through 8 layers."""
    kw = dict(context_layer='kernelselect', transformer_block=True,
              channel_list=(8, 16, 16, 32))
    plain = UnetBackbone(**kw).eval()
    flash = UnetBackbone(flash_attention=True, **kw).eval()
    assert all(layer.ma.use_flash for layer in flash.aspp4.tr)
    assert not any(layer.ma.use_flash for layer in plain.aspp5.tr)
    gen = torch.Generator().manual_seed(0)
    for p in plain.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    flash.load_state_dict(plain.state_dict(), strict=True)
    x = torch.rand(1, 3, 64, 64, generator=gen)
    with torch.no_grad():
        for a, b in zip(plain(x), flash(x)):
            torch.testing.assert_close(
                b, a, rtol=1e-4, atol=1e-5 * a.abs().max().item())


def test_transformer_block_flash_matches_jax():
    """One TransformerBlock (2 layers) with the flash path in training, f32:
    its output and the gradients of its input and every parameter against
    JAX's (jax.vjp in interpret mode)."""
    c, heads, layers = 16, 2, 2
    rng = np.random.RandomState(4)
    x = rng.randn(1, 16, 8, c).astype(np.float32)   # 128 tokens
    do = rng.randn(1, 16, 8, c).astype(np.float32)
    variables = _np(JBlock(c, heads, layers).init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    jb = JBlock(c, heads, layers, use_flash=True)
    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(lambda p, a: jb.apply({'params': p}, a,
                                                train=True),
                          variables['params'], jnp.asarray(x))
        jdp, jdx = vjp(jnp.asarray(do))
    tb = TransformerBlock(c, heads, layers, use_flash=True).train()
    tb.load_state_dict(_state(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = tb(xt)
    y.backward(torch.from_numpy(do).permute(0, 3, 1, 2))
    _close(y.detach().permute(0, 2, 3, 1), jy)
    _close(xt.grad.permute(0, 2, 3, 1), jdx, rtol=1e-4)
    jgrad = _state({'params': _np(jdp)})
    assert sorted(jgrad) == sorted(k for k, _ in tb.named_parameters())
    for name, p in tb.named_parameters():
        _close(p.grad, jgrad[name].numpy(), rtol=1e-4)


# -- kernel P: the probe's single-pass dual strip pool ----------------------

# (shape, row block): the first case keeps its ids; the others have H not a
# multiple of 8 and C = 13
DUAL_POOL_CASES = [
    pytest.param((2, 16, 8, 24), 4, dtype, id=dtype)
    for dtype in ('float32', 'bfloat16')] + [
    pytest.param(shape, bh, dtype, id=f'h{shape[1]}-c13-{dtype}')
    for shape, bh in (((2, 15, 9, 13), 5), ((3, 20, 11, 13), 4))
    for dtype in ('float32', 'bfloat16')]


@pytest.mark.parametrize('shape,bh,dtype', DUAL_POOL_CASES)
def test_dual_pools_plain_version_matches_the_probe_kernel(shape, bh, dtype):
    """dual_pools (its plain version on the CPU: two f32 sums) against the
    probe's _pools_pallas in interpret mode; H in several row blocks of bh
    rows."""
    sys.path.insert(0, TOOLS)
    try:
        from probe_coordatt import _pools_pallas
    finally:
        sys.path.remove(TOOLS)
    n, h, w, c = shape
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    with pltpu.force_tpu_interpret_mode():
        jh, jw = _pools_pallas(jx, bh)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    sh, sw = tdp.dual_pools(tx)
    assert sh.dtype == sw.dtype == torch.float32
    assert sh.shape == (n, h, c) and sw.shape == (n, w, c)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    assert tdp.dual_pools.launches == 0


def test_probe_tool_needs_a_card(monkeypatch, capsys):
    """The port's CoordAtt probe times P on the card only: without CUDA it
    exits 1 and prints no record."""
    from stc_unet_tpu_torch.tools import probe_coordatt
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert probe_coordatt.main([]) == 1
    assert capsys.readouterr().out == ''
    with pytest.raises(RuntimeError, match='CUDA card'):
        probe_coordatt.probe()


# -- the ablation probe of Ldkv and Ldq ---------------------------------------

def test_flash_bwd_probe_needs_a_card(monkeypatch, capsys):
    """The backward ablation probe builds and times on the card only:
    without CUDA it exits 1 and prints no record."""
    from stc_unet_tpu_torch.tools import probe_flash_bwd
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert probe_flash_bwd.main([]) == 1
    assert capsys.readouterr().out == ''
    with pytest.raises(RuntimeError, match='CUDA card'):
        probe_flash_bwd.probe()


@pytest.mark.parametrize('variant', ['base', 'no_scores', 'no_grads',
                                     'no_prefetch', 'masked_copy',
                                     'trunc_hi', 'cvt_rna_hi'])
def test_flash_bwd_probe_edits_apply_to_the_source(variant):
    """Each variant's edits match the kernel source as often as they
    should, and only ``base`` leaves it as it is."""
    from stc_unet_tpu_torch.ops import _build
    from stc_unet_tpu_torch.tools import probe_flash_bwd
    source = (_build.SRC_DIR / 'flash_attention.cu').read_text()
    edited = probe_flash_bwd.variant_source(variant, source)
    assert (edited == source) == (variant == 'base')
    assert 'flash_bwd_dkv_tc' in edited and 'flash_bwd_dq_tc' in edited


def test_flash_bwd_probe_reads_ptxas_and_sass():
    """The probe's counts of the timed kernels (DP = 256, 16-byte copies)
    from nvcc's ptxas lines and from ``cuobjdump -sass`` text, past
    address 0xffff too; other kernels are left out."""
    from stc_unet_tpu_torch.tools import probe_flash_bwd
    dkv = '_ZN12_GLOBAL__N_116flash_bwd_dkv_tcILi256ELb1EEEvNS_4RowsE'
    dq32 = '_ZN12_GLOBAL__N_115flash_bwd_dq_tcILi32ELb1EEEvNS_4RowsE'
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{dkv}' for 'sm_90a'",
        f'ptxas info    : Function properties for {dkv}',
        '    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads',
        'ptxas info    : Used 255 registers, used 1 barriers',
        f"ptxas info    : Compiling entry function '{dq32}' for 'sm_90a'",
        'ptxas info    : Used 96 registers, used 1 barriers'])
    assert probe_flash_bwd.ptxas_usage(log) == {
        'flash_bwd_dkv_tc': {'spill_bytes': 8, 'registers': 255}}
    sass = '\n'.join([
        f'\t\tFunction : {dkv}',
        '        /*fff0*/   IMAD.MOV.U32 R1, RZ, RZ, R2 ;',
        '        /*10000*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;',
        '        /*10010*/  EXIT ;',
        f'\t\tFunction : {dq32}',
        '        /*0000*/   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;'])
    assert probe_flash_bwd.count_sass(sass) == {
        'flash_bwd_dkv_tc': {'instructions': 3, 'tf32_mmas': 1}}


def _tf32(x, nearest=True):
    """x (float32) rounded to TF32's 10 mantissa bits on the float32 bit
    pattern: to nearest with ties away from zero (``cvt.rna.tf32.f32``), or
    toward zero (the tensor core reading an f32 register as TF32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32x3(a, b, lo_nearest):
    """a·b with each operand split as the card's Ldkv and Ldq split it: hi
    = tf32(x) and lo = tf32(x - hi), lo·hi + hi·lo + hi·hi. This models the
    operand splitting only: the sums are numpy's f32 matmul, rounded to
    nearest, not the MMA's (``_mma_sum``)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, lo_nearest), _tf32(b - bh, lo_nearest)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize('lo_rounding', ['nearest', 'toward zero'])
@pytest.mark.parametrize('product', ['dq = ds k', 'dk = ds^T q'])
def test_tf32_split_keeps_the_backward_at_f32_accuracy(product, lo_rounding):
    """Why Ldkv and Ldq split every operand: at the model's width (d = 256,
    1024 keys, 32 query rows, from a seed) 3xTF32 products stay within the
    card check's limits (rtol 1e-4, atol 1e-5 of the largest value) of the
    f64 product of the same f32 inputs, with lo rounded to nearest or, as
    the kernels leave it to the tensor core, toward zero; single-pass TF32
    does not."""
    rng = np.random.RandomState(11)
    rows, keys, d = 32, 1024, 256
    q, do = rng.randn(2, rows, d)
    k, v = rng.randn(2, keys, d)
    scale = d ** -0.5
    s = q @ k.T * scale
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    di = (p @ v * do).sum(1)
    ds = (p * (do @ v.T - di[:, None]) * scale).astype(np.float32)
    a, b = ((ds, k.astype(np.float32)) if product == 'dq = ds k' else
            (np.ascontiguousarray(ds.T), q.astype(np.float32)))
    want = a.astype(np.float64) @ b.astype(np.float64)
    limit = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert np.all(np.abs(_tf32x3(a, b, lo_rounding == 'nearest') - want) <=
                  limit)
    assert not np.all(np.abs(_tf32(a) @ _tf32(b) - want) <= limit)


def _toward_zero(x):
    """x (float64) rounded to float32 toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


@pytest.mark.parametrize('seed', [0, 1])
def test_mma_sum_in_fresh_chunks_keeps_dv_at_f32_accuracy(seed):
    """Why Ldkv and Ldq sum every 32 rows in fresh accumulators. A model of
    the MMA's f32 sum: each m16n8k8 step adds its eight exact TF32 products
    to the accumulator and rounds toward zero. dv = p^T do over 4096 rows
    (32 keys, d = 256, the split operands of ``_tf32x3``): one chain of all
    1536 steps drifts past the card check's limits (rtol 1e-4, atol 1e-5 of
    the largest value) of the f64 product; a chain per 32 rows, its sums
    added in f32 to nearest, stays well inside them."""
    rng = np.random.RandomState(seed)
    rows, keys, d = 4096, 32, 256
    q, k = rng.randn(rows, d), rng.randn(rows, d)
    s = q @ k.T / 16
    p = np.exp(s - s.max(1, keepdims=True))
    p = (p / p.sum(1, keepdims=True))[:, :keys].astype(np.float32)
    a, b = np.ascontiguousarray(p.T), rng.randn(rows, d).astype(np.float32)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    terms = [(x.astype(np.float64), y.astype(np.float64))
             for x, y in ((al, bh), (ah, bl), (ah, bh))]
    chain = chunked = np.zeros((keys, d), np.float32)
    for r0 in range(0, rows, 32):
        part = np.zeros((keys, d), np.float32)
        for r in range(r0, r0 + 32, 8):
            for x, y in terms:
                step = x[:, r:r + 8] @ y[r:r + 8]
                chain = _toward_zero(chain + step)
                part = _toward_zero(part + step)
        chunked = chunked + part
    want = a.astype(np.float64) @ b.astype(np.float64)
    limit = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert not np.all(np.abs(chain - want) <= limit)
    assert np.all(np.abs(chunked - want) <= 0.1 * limit)


def _split(x):
    """x (float32) as the kernels split it: hi = tf32(x) to nearest, lo =
    x - hi, which the tensor core reads truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi, False)


@pytest.mark.parametrize('seed', [0, 1])
def test_fresh_tile_sums_keep_the_forward_at_f32_accuracy(seed):
    """Why Lf sums each key tile's p·v in fresh accumulators. The online
    softmax as the card's Lf runs it over 4096 keys in tiles of 32 (16
    query rows, d = 256, the model's scale 1/16): per tile the row max m,
    alpha = exp(m_old - m), p = exp(s - m) and l = l·alpha + Σp in f32,
    and p·v from the split operands of ``_tf32x3``, each m16n8k8 step
    rounded toward zero as ``_toward_zero`` models the MMA's sum. One chain
    of o (rescaled by alpha in f32, then every step added to it) drifts
    past the card check's limits (rtol 1e-4, atol 1e-5 of the largest
    value) of the f64 softmax·v of the same scores; a fresh sum per tile,
    added as o·alpha + part in f32 to nearest, stays well inside them."""
    rng = np.random.RandomState(seed)
    rows, keys, d = 16, 4096, 256
    q, k = rng.randn(rows, d), rng.randn(keys, d)
    v = rng.randn(keys, d).astype(np.float32)
    s = (q @ k.T / 16).astype(np.float32)
    vh, vl = _split(v)
    chain = fresh = np.zeros((rows, d), np.float32)
    m = np.full(rows, -np.inf, np.float32)
    l = np.zeros(rows, np.float32)
    for k0 in range(0, keys, 32):
        tile = s[:, k0:k0 + 32]
        m_new = np.maximum(m, tile.max(1))
        alpha = np.exp(m - m_new)
        p = np.exp(tile - m_new[:, None])
        l = l * alpha + p.sum(1, dtype=np.float32)
        ph, pl = _split(p)
        chain = chain * alpha[:, None]
        part = np.zeros((rows, d), np.float32)
        for j in range(0, 32, 8):
            keys8 = slice(k0 + j, k0 + j + 8)
            for x, y in ((pl, vh), (ph, vl), (ph, vh)):
                step = (x[:, j:j + 8].astype(np.float64) @
                        y[keys8].astype(np.float64))
                chain = _toward_zero(chain + step)
                part = _toward_zero(part + step)
        fresh = (fresh.astype(np.float64) * alpha[:, None] + part).astype(
            np.float32)
        m = m_new
    e = np.exp(s.astype(np.float64) - s.max(1, keepdims=True))
    want = (e / e.sum(1, keepdims=True)) @ v.astype(np.float64)
    limit = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert not np.all(np.abs(chain / l[:, None] - want) <= limit)
    assert np.all(np.abs(fresh / l[:, None] - want) <= 0.1 * limit)
