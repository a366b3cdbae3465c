"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (the kernels have no CPU
mode); without a card they skip. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1's and K2b's f32 sums are taken in another order than
``torch.sum`` (rtol 1e-5, atol 1e-4) and are bit-identical from run to
run; K2 rounds as the plain version does (f32 rtol/atol 1e-6, bf16
exact). K3f and K3b (window attention) sum in another order than the
plain version: f32 rtol 1e-4 and atol 1e-5 of the largest value; in bf16
an attention weight or a ds entry may round to the other neighbour, so
rtol 2^-7 and atol 2^-7 of the largest value (dbias stays f32). At rate
0.1 both draw the same Philox mask, so the rate-0 limits hold; K3b's
reruns are bit-identical. The K3 edge cases cover N of 1 to 64, every head
width, W of 1 to 65536 and rows of any alignment. Lf, Ldkv and Ldq (flash
attention, f32) sum in another order and with an online softmax: rtol
1e-4 and atol 1e-5 of the largest value; their reruns are bit-identical,
and do not change with
``torch.backends.cuda.matmul.allow_tf32``. P (the probe's dual strip
pool) as K1, also at W of 2049, H of 1025, N of 65536, off 16-byte
alignment and with either way of adding its bands. K1 and K2b are also
held to theirs at the edges of their tiling (odd C, H past 8 bands, W of 1
and 2049, tensors one element off a 16-byte boundary). Every other family
is also held to its plain version at the 65535 that a grid's y or z holds
and one past it (N images, W windows, N·heads), with bit-identical
reruns.
"""
import math

import pytest
import torch

from stc_unet_tpu_torch.ops import coordatt_fused as tfused
from stc_unet_tpu_torch.ops import dual_pools as tdp
from stc_unet_tpu_torch.ops import flash_attention_backward_reference
from stc_unet_tpu_torch.ops import window_attention as twa
from stc_unet_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_forward, flash_attention_reference)

SHAPES = [(2, 8, 16, 24), (1, 16, 8, 128), (3, 4, 4, 8), (3, 37, 53, 24)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES + [(2, 256, 256, 128),
                                            (2, 512, 512, 128),
                                            (1, 130, 71, 40),
                                            (2, 19, 23, 13)])
def test_kernels_match_plain_versions_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    n, h, w, c = shape
    a_h = torch.rand((n, h, c), generator=g, device=cuda_device).to(dtype)
    a_w = torch.rand((n, w, c), generator=g, device=cuda_device).to(dtype)
    sh, sw = tfused.strip_pools(x)
    sh2, sw2 = tfused.strip_pools(x)
    eh, ew = tfused.strip_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    assert torch.equal(sh, sh2) and torch.equal(sw, sw2)
    out = tfused.gate_add(x, a_h, a_w)
    ref = tfused.gate_add_reference(x, a_h, a_w)
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(out, ref)


@pytest.mark.cuda
def test_strip_pools_backward_on_card(cuda_device):
    x = torch.randn(2, 70, 9, 16, device=cuda_device, requires_grad=True)
    sh, sw = tfused.strip_pools(x)
    (sh.sin().sum() + (sw * sw).sum()).backward()
    xr = x.detach().clone().requires_grad_(True)
    rh, rw = tfused.strip_pools_reference(xr)
    (rh.sin().sum() + (rw * rw).sum()).backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', SHAPES + [(2, 512, 512, 128),
                                            (2, 64, 64, 1024),
                                            (1, 130, 71, 40),
                                            (2, 19, 23, 13)])
def test_gate_dots_matches_plain_version_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    do = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    n, h, w, c = shape
    a_h = torch.rand((n, h, c), generator=g, device=cuda_device).to(dtype)
    a_w = torch.rand((n, w, c), generator=g, device=cuda_device).to(dtype)
    before = tfused.gate_dots.launches
    dh, dw = tfused.gate_dots(do, a_h, a_w)
    dh2, dw2 = tfused.gate_dots(do, a_h, a_w)
    assert tfused.gate_dots.launches == before + 2
    eh, ew = tfused.gate_dots_reference(do, a_h, a_w)
    assert dh.dtype == dw.dtype == torch.float32
    torch.testing.assert_close(dh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, ew, rtol=1e-5, atol=1e-4)
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)


# edges of K1's and K2b's tiling (csrc/coordatt_fused.cu): C of 13, 24 and
# 40 (the scalar path) and 1024 (16 or 32 vector tiles); H of 1, 64, 65,
# 513 and 1025 (one band of 4 rows, one of 64, two, nine and 17 bands);
# W of 1 and 2049 (chunks of 16 or 32 pixels, groups of 8)
STRIP_EDGES = [(2, 5, 7, 13), (3, 9, 11, 24), (1, 33, 6, 40),
               (2, 64, 3, 1024), (3, 1, 5, 64), (2, 64, 9, 64),
               (1, 65, 7, 64), (1, 513, 3, 64), (1, 1025, 2, 32),
               (2, 5, 1, 64), (1, 5, 2049, 64), (1, 70, 2049, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize('misaligned', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', STRIP_EDGES)
def test_strip_sums_tiling_edges_on_card(cuda_device, shape, dtype,
                                         misaligned):
    """K1 and K2b at the edges of their tiling against their plain
    versions (rtol 1e-5, atol 1e-4), reruns bit-identical; ``misaligned``
    takes x (or do), a_h and a_w one element (2 or 4 bytes) past a 16-byte
    boundary, slices of larger tensors, which the wrapper runs one element
    a lane."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n, h, w, c = shape

    def draw(*size, rand=False):
        count = math.prod(size) + (8 if misaligned else 0)
        fn = torch.rand if rand else torch.randn
        t = fn(count, generator=g, device=cuda_device).to(dtype)
        return (t[1:1 + math.prod(size)] if misaligned else t).view(size)
    x = draw(n, h, w, c)
    a_h = draw(n, h, c, rand=True)
    a_w = draw(n, w, c, rand=True)
    assert (x.data_ptr() % 16 != 0) == misaligned
    for fn, ref, args in ((tfused.strip_pools, tfused.strip_pools_reference,
                           (x,)),
                          (tfused.gate_dots, tfused.gate_dots_reference,
                           (x, a_h, a_w))):
        got, again, want = fn(*args), fn(*args), ref(*args)
        for a, b, e in zip(got, again, want):
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-4)
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gate_add_backward_launches_gate_dots(cuda_device, dtype):
    """The autograd backward of gate_add is K2b, fed a grad that comes
    back through a permute (not contiguous)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    n, h, w, c = 2, 70, 9, 16
    x = torch.randn((n, h, w, c), generator=g, device=cuda_device).to(dtype)
    a_h = torch.rand((n, h, c), generator=g, device=cuda_device).to(dtype)
    a_w = torch.rand((n, w, c), generator=g, device=cuda_device).to(dtype)
    up = torch.randn((n, c, h, w), generator=g, device=cuda_device).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, a_h, a_w)]
    before = tfused.gate_dots.launches
    (tfused.gate_add(*leaves).permute(0, 3, 1, 2) * up).sum().backward()
    assert tfused.gate_dots.launches == before + 1
    do = up.permute(0, 2, 3, 1)
    eh, ew = tfused.gate_dots_reference(do, a_h, a_w)
    assert torch.equal(leaves[0].grad, do)
    # f32 sums in another order; in bf16 the one rounding of each sum to
    # bf16 may land one ulp (2^-8 relative) apart
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-4))
    torch.testing.assert_close(leaves[1].grad, eh.to(dtype), **tol)
    torch.testing.assert_close(leaves[2].grad, ew.to(dtype), **tol)


def _close(got, want, dtype, f32_exact=False):
    top = want.float().abs().max().item()
    tol = (dict(rtol=1e-4, atol=1e-5 * top)
           if dtype == torch.float32 or f32_exact
           else dict(rtol=2 ** -7, atol=2 ** -7 * top))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('w,n,c,heads,rate', [
    (2048, 64, 64, 32, 0.0), (32, 64, 512, 32, 0.0), (16, 64, 64, 32, 0.1),
    (100, 16, 16, 2, 0.1), (67, 49, 16, 4, 0.0)])
def test_window_attention_matches_plain_versions_on_card(
        cuda_device, dtype, w, n, c, heads, rate):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn((w, n, 3 * c), generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias_e = 0.1 * torch.randn((n, heads * n), generator=g,
                               device=cuda_device)
    seed = torch.randint(2 ** 62, (1,), generator=g, device=cuda_device)
    do = torch.randn((w, n, c), generator=g, device=cuda_device).to(dtype)
    scale = heads ** -0.5
    before = (twa.window_attention.launches,
              twa.window_attention_backward.launches)
    out = twa.window_attention(q, k, v, bias_e, seed, heads, scale, rate)
    grads = twa.window_attention_backward(q, k, v, bias_e, seed, do, heads,
                                          scale, rate)
    again = twa.window_attention_backward(q, k, v, bias_e, seed, do, heads,
                                          scale, rate)
    assert (twa.window_attention.launches,
            twa.window_attention_backward.launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert out.dtype == dtype and grads[3].dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _close(out, twa.window_attention_reference(q, k, v, bias_e, seed, heads,
                                               scale, rate), dtype)
    refs = twa.window_attention_backward_reference(q, k, v, bias_e, seed, do,
                                                   heads, scale, rate)
    for i, (got, want) in enumerate(zip(grads, refs)):
        _close(got, want, dtype, f32_exact=i == 3)


def _window_inputs(device, w, n, c, heads, dtype, layout, seed):
    """q, k, v, bias_e, seed, do. ``layout``: 'qkv' the thirds of one qkv
    row (stride 3C), 'own' three contiguous tensors (stride C), 'odd' the
    thirds of rows of 3C + 1 (2-byte aligned rows in bf16)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if layout == 'own':
        q, k, v = (torch.randn((w, n, c), generator=g, device=device)
                   .to(dtype) for _ in range(3))
    else:
        qkv = torch.randn((w, n, 3 * c + (layout == 'odd')), generator=g,
                          device=device).to(dtype)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:3 * c]
    bias_e = 0.1 * torch.randn((n, heads * n), generator=g, device=device)
    sd = torch.randint(2 ** 62, (1,), generator=g, device=device)
    do = torch.randn((w, n, c), generator=g, device=device).to(dtype)
    return q, k, v, bias_e, sd, do


# K3f and K3b give a warp 16 rows, take keys in 8 tiles of 8 and pad d to
# 8 or 16: N of 1, 33, 49, 63 and 64, every d, W of 1, odd ones that are no
# multiple of K3b's chunk and 65536, row strides of C, 3C and 3C + 1, and
# 3 heads of d = 2, whose k and v thirds start 12 bytes apart in bf16
WINDOW_EDGES = [(1, 1, 8, 4, 'qkv'), (1, 64, 512, 32, 'own'),
                (131, 63, 32, 4, 'qkv'), (3, 64, 6, 3, 'qkv'),
                (7, 49, 64, 4, 'own'), (9, 33, 24, 6, 'odd'),
                (65, 64, 16, 4, 'odd'), (65536, 4, 4, 2, 'qkv')]


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('w,n,c,heads,layout', WINDOW_EDGES)
def test_window_attention_tiling_edges_on_card(cuda_device, w, n, c, heads,
                                               layout, dtype, rate):
    """K3f and K3b at the edges of their tiling and copies, against their
    plain versions (the same draws at rate 0.1); K3b's rerun
    bit-identical."""
    q, k, v, bias_e, seed, do = _window_inputs(cuda_device, w, n, c, heads,
                                               dtype, layout, 8)
    scale = heads ** -0.5
    out = twa.window_attention(q, k, v, bias_e, seed, heads, scale, rate)
    grads = twa.window_attention_backward(q, k, v, bias_e, seed, do, heads,
                                          scale, rate)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, twa.window_attention_backward(q, k, v, bias_e, seed, do,
                                             heads, scale, rate)))
    _close(out, twa.window_attention_reference(q, k, v, bias_e, seed, heads,
                                               scale, rate), dtype)
    refs = twa.window_attention_backward_reference(q, k, v, bias_e, seed, do,
                                                   heads, scale, rate)
    for i, (got, want) in enumerate(zip(grads, refs)):
        _close(got, want, dtype, f32_exact=i == 3)


# Ldkv and Ldq tile 32 keys and 32 query rows, Lf 64 query rows and 32
# keys, and all pad d with zeros to 32, 64, 128 or 256 (the MMA depth is
# 8): lengths one below and above a tile, or two, 1 and 4097, and widths
# that are no multiple of 8 or just past a padding
FLASH_EDGES = [(1, 2, 63, 31, 64), (2, 1, 65, 33, 32), (1, 2, 129, 63, 128),
               (1, 1, 63, 65, 256), (2, 2, 65, 31, 1), (1, 2, 129, 33, 7),
               (1, 2, 63, 65, 255), (1, 1, 33, 129, 33), (1, 2, 1, 1, 33),
               (2, 2, 1, 4097, 1), (1, 2, 4097, 65, 255),
               (1, 1, 4097, 4097, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize('n,h,lq,lk,d', [
    (2, 2, 1024, 1024, 256), (1, 2, 256, 256, 256), (2, 2, 100, 100, 64),
    (1, 3, 1000, 37, 256), (2, 2, 77, 1000, 8), (1, 1, 16, 16, 8),
    (1, 2, 129, 200, 100)] + FLASH_EDGES)
def test_flash_attention_matches_plain_versions_on_card(cuda_device, n, h,
                                                        lq, lk, d):
    """Lf, Ldkv and Ldq against their plain versions; reruns bit-identical,
    also with TF32 matmuls allowed: their 3xTF32 split never reads the
    flag."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q = torch.randn((n, h, lq, d), generator=g, device=cuda_device)
    k, v = (torch.randn((n, h, lk, d), generator=g, device=cuda_device)
            for _ in range(2))
    do = torch.randn((n, h, lq, d), generator=g, device=cuda_device)
    scale = d ** -0.5
    before = (flash_attention_forward.launches,
              flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    o, lse = flash_attention_forward(q, k, v, scale)
    o2, lse2 = flash_attention_forward(q, k, v, scale)
    di = (o * do).sum(-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    dq = flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    dq2 = flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        o3, lse3 = flash_attention_forward(q, k, v, scale)
        dk3, dv3 = flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
        dq3 = flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert (flash_attention_forward.launches,
            flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == (before[0] + 3,
                                                 before[1] + 3,
                                                 before[2] + 3)
    for a, b in ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2),
                 (o, o3), (lse, lse3), (dk, dk3), (dv, dv3), (dq, dq3)):
        assert torch.equal(a, b)
    ro, rlse = flash_attention_reference(q, k, v, scale)
    _close(o, ro, torch.float32)
    _close(lse, rlse, torch.float32)
    rdq, rdk, rdv = flash_attention_backward_reference(q, k, v, ro, rlse, do,
                                                       scale)
    _close(dv, rdv, torch.float32)
    if lk == 1:
        # one key: p = 1 and ds = 0, so dq and dk vanish and both sides give
        # rounding noise; held to zero at 1e-5 of the largest dv
        assert max(dq.abs().max(), dk.abs().max()) <= 1e-5 * rdv.abs().max()
    else:
        _close(dq, rdq, torch.float32)
        _close(dk, rdk, torch.float32)


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda_device):
    """The autograd Function on strided views, as the model gives them: one
    Lf launch forward, one Ldkv and one Ldq backward."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 300, 3 * 512), generator=g, device=cuda_device)
    leaves = [x[..., i * 512:(i + 1) * 512].reshape(2, 300, 2, 256)
              .transpose(1, 2).detach().requires_grad_(True)
              for i in range(3)]
    assert not leaves[0].is_contiguous()
    do = torch.randn((2, 2, 300, 256), generator=g, device=cuda_device)
    before = (flash_attention_forward.launches,
              flash_attention_bwd_dkv.launches,
              flash_attention_bwd_dq.launches)
    out = flash_attention(*leaves, sm_scale=0.0625)
    out.backward(do)
    assert (flash_attention_forward.launches,
            flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dq.launches) == tuple(b + 1 for b in before)
    ro, rlse = flash_attention_reference(*leaves, 0.0625)
    _close(out.detach(), ro, torch.float32)
    for leaf, want in zip(leaves, flash_attention_backward_reference(
            *leaves, ro, rlse, do, 0.0625)):
        _close(leaf.grad, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('count', [65535, 65536])
@pytest.mark.parametrize('family', ['coordatt', 'window', 'flash'])
def test_kernels_pass_the_old_grid_limit_on_card(cuda_device, family,
                                                 count):
    """At 65535 (the most a grid's y or z holds) and one past it: N
    images for K1, K2 and K2b, W windows for K3f and K3b (rate 0.1), N·heads
    for Lf, Ldkv and Ldq; each against its plain version at the limits
    above, each rerun bit-identical. Tiny rows keep each case to a few
    tens of MB."""
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    if family == 'coordatt':
        x, do = randn(count, 2, 3, 33), randn(count, 2, 3, 33)
        a_h, a_w = randn(count, 2, 33), randn(count, 3, 33)
        for fn, ref, args, tol in (
                (tfused.strip_pools, tfused.strip_pools_reference, (x,),
                 dict(rtol=1e-5, atol=1e-4)),
                (tfused.gate_add, tfused.gate_add_reference, (x, a_h, a_w),
                 dict(rtol=1e-6, atol=1e-6)),
                (tfused.gate_dots, tfused.gate_dots_reference,
                 (do, a_h, a_w), dict(rtol=1e-5, atol=1e-4))):
            got, again = fn(*args), fn(*args)
            torch.testing.assert_close(got, ref(*args), **tol)
            if isinstance(got, torch.Tensor):
                got, again = (got,), (again,)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
    elif family == 'window':
        qkv = randn(count, 4, 6)
        q, k, v = qkv[..., :2], qkv[..., 2:4], qkv[..., 4:]
        bias_e, do = 0.1 * randn(4, 4), randn(count, 4, 2)
        seed = torch.randint(2 ** 62, (1,), generator=g, device=cuda_device)
        args = (q, k, v, bias_e, seed)
        out = twa.window_attention(*args, 1, 1.0, 0.1)
        grads = twa.window_attention_backward(*args, do, 1, 1.0, 0.1)
        assert torch.equal(out, twa.window_attention(*args, 1, 1.0, 0.1))
        assert all(torch.equal(a, b) for a, b in zip(
            grads, twa.window_attention_backward(*args, do, 1, 1.0, 0.1)))
        _close(out, twa.window_attention_reference(*args, 1, 1.0, 0.1),
               torch.float32)
        for got, want in zip(grads, twa.window_attention_backward_reference(
                *args, do, 1, 1.0, 0.1)):
            _close(got, want, torch.float32)
    else:
        n, h = (count, 1) if count % 2 else (count // 2, 2)
        q, do = randn(n, h, 3, 8), randn(n, h, 3, 8)
        k, v = randn(n, h, 5, 8), randn(n, h, 5, 8)
        o, lse = flash_attention_forward(q, k, v, 0.5)
        di = (o * do).sum(-1)
        outs = (o, lse) + flash_attention_bwd_dkv(q, k, v, lse, do, di, 0.5) \
            + (flash_attention_bwd_dq(q, k, v, lse, do, di, 0.5),)
        again = flash_attention_forward(q, k, v, 0.5) + \
            flash_attention_bwd_dkv(q, k, v, lse, do, di, 0.5) + \
            (flash_attention_bwd_dq(q, k, v, lse, do, di, 0.5),)
        assert all(torch.equal(a, b) for a, b in zip(outs, again))
        ro, rlse = flash_attention_reference(q, k, v, 0.5)
        dq, dk, dv = flash_attention_backward_reference(q, k, v, ro, rlse,
                                                        do, 0.5)
        for got, want in zip(outs, (ro, rlse, dk, dv, dq)):
            _close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(14, 256, 256, 128), (14, 32, 32, 1024),
                                   (3, 37, 53, 40), (1, 130, 71, 13),
                                   (1, 70, 2049, 32), (1, 1025, 3, 64),
                                   (65536, 2, 3, 13)])
def test_dual_pools_matches_plain_version_on_card(cuda_device, shape, dtype):
    """P against its plain version (rtol 1e-5, atol 1e-4), reruns
    bit-identical: as planned, with x one element past a 16-byte boundary
    (one element a lane), and where the shape has 2 to 8 bands with the
    last band block adding them in place of the cluster. W of 2049, H of
    1025 (17 bands) and N of 65536 (past the old grid limit) included."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    before = tdp.dual_pools.launches
    sh, sw = tdp.dual_pools(x)
    sh2, sw2 = tdp.dual_pools(x)
    assert tdp.dual_pools.launches == before + 2
    eh, ew = tdp.dual_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    assert torch.equal(sh, sh2) and torch.equal(sw, sw2)
    off = torch.empty(x.numel() + 8, dtype=dtype, device=cuda_device)
    off = off[1:1 + x.numel()].view(shape)
    off.copy_(x)
    assert off.data_ptr() % 16 != 0
    runs = [(off, None)]
    if tdp.dual_plan(shape, x.element_size(), True)['combine'] == 'cluster':
        runs.append((x, 'last'))
    for t, combine in runs:
        got = tdp._dual_pools_kernel(t, combine)
        again = tdp._dual_pools_kernel(t, combine)
        for a, b, e in zip(got, again, (eh, ew)):
            torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-4)
            assert torch.equal(a, b)
