"""The port's window attention (``stc_unet_tpu_torch/ops/window_attention.py``)
against the JAX package's, on the CPU.

On CPU tensors the port computes its plain versions of K3f and K3b, which
follow the TPU kernel's roundings. They are held to JAX's
``window_attention(..., interpret=True)`` (the Pallas kernel under the
interpreter) and to its einsum ``window_attention_reference``, at the JAX
test's cases (``tests/test_ops/test_window_attention.py``) plus MaxViT's
head layout (32 heads of width 2 over 64-token windows), with W = 4.

Tolerances: f32 at rtol/atol 2e-5, as the JAX test holds its kernel. bf16
(against the kernel only; the einsum formulation rounds its scores to bf16)
within 2 bf16 ulps, rtol 2⁻⁷: attn is rounded to bf16 before the apply, and
a sum taken in another order can flip that rounding. The gradients of the
interpret kernel (``jax.vjp``) at rtol 1e-4 / atol 1e-5, f32 sums in
another order compounded through the softmax backward.

JAX's in-kernel dropout (``pltpu.prng_*``) has no CPU rule, so at rate > 0
the port is held to itself: the draws are Philox4x32-10 (checked against
the Random123 test vectors), the keep rate is within binomial bounds, a
seed gives one output, and the gradient along v at rate 0.4 matches a
finite difference in f64, which holds only if the backward draws the
forward's mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_unet_tpu.ops.window_attention import window_attention as jax_wa
from stc_unet_tpu.ops.window_attention import \
    window_attention_reference as jax_wa_reference
from stc_unet_tpu_torch.ops import window_attention as twa

CASES = [(4, 2, 16), (2, 8, 8), (8, 4, 32), (32, 2, 64)]   # heads, d, N


def _inputs(heads, d, n, w=4, seed=0):
    """q, k, v (W, N, C), the (H, N, N) bias and its (N, H·N) layout."""
    rng = np.random.RandomState(seed)
    c = heads * d
    q, k, v = (rng.randn(w, n, c).astype(np.float32) for _ in range(3))
    bias = (rng.randn(heads, n, n) * 0.1).astype(np.float32)
    bias_e = np.ascontiguousarray(bias.transpose(1, 0, 2).reshape(
        n, heads * n))
    return q, k, v, bias, bias_e


def _jax_kernel(q, k, v, bias_e, heads, dtype=jnp.float32):
    out = jax_wa(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                 jnp.asarray(bias_e), jnp.zeros((1,), jnp.int32), heads,
                 heads ** -0.5, 0.0, True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, bias_e, heads, dtype=torch.float32, rate=0.0, seed=0):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return twa.window_attention(*t, torch.from_numpy(bias_e),
                                torch.tensor([seed]), heads, heads ** -0.5,
                                rate)


@pytest.mark.parametrize('heads,d,n', CASES)
def test_forward_matches_jax(heads, d, n):
    q, k, v, bias, bias_e = _inputs(heads, d, n)
    out = _port(q, k, v, bias_e, heads)
    assert out.shape == q.shape and out.dtype == torch.float32
    kernel = _jax_kernel(q, k, v, bias_e, heads)
    reference = np.asarray(jax_wa_reference(
        *(jnp.asarray(a) for a in (q, k, v, bias)), heads, heads ** -0.5))
    for ref in (kernel, reference):
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    plain = twa.window_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, bias_e)), torch.zeros(1),
        heads, heads ** -0.5)
    assert torch.equal(out, plain)


@pytest.mark.parametrize('heads,d,n', CASES)
def test_bf16_forward_matches_the_jax_kernel(heads, d, n):
    q, k, v, _, bias_e = _inputs(heads, d, n, seed=1)
    out = _port(q, k, v, bias_e, heads, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = _jax_kernel(q, k, v, bias_e, heads, jnp.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize('heads,d,n', [(4, 4, 16), (32, 2, 64)])
def test_gradients_match_jax_vjp(heads, d, n):
    """dq, dk, dv and dbias of the port's autograd (the plain K3b on the
    CPU) against ``jax.vjp`` of the interpret kernel, rate 0, f32."""
    q, k, v, _, bias_e = _inputs(heads, d, n, w=2, seed=3)
    do = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    scale = heads ** -0.5
    _, vjp = jax.vjp(
        lambda *a: jax_wa(*a, jnp.zeros((1,), jnp.int32), heads, scale,
                          0.0, True),
        *(jnp.asarray(a) for a in (q, k, v, bias_e)))
    ref = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (q, k, v, bias_e)]
    out = twa.window_attention(*leaves, torch.zeros(1, dtype=torch.int64),
                               heads, scale)
    out.backward(torch.from_numpy(do))
    for leaf, r, name in zip(leaves, ref, ('dq', 'dk', 'dv', 'dbias')):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_philox_matches_the_random123_vectors():
    """Philox4x32-10's known answers (Random123 ``kat_vectors``)."""
    def t(*words):
        return [torch.tensor(w, dtype=torch.int64) for w in words]

    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0xffffffff,) * 4, (0xffffffff,) * 2,
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        got = twa.philox4x32(*t(*ctr), *t(*key))
        assert tuple(int(x) for x in got) == want
    # philox_bits is word 0 at (counter lo, counter hi, 0, 0)
    counter = torch.tensor([0, 5, 2 ** 40 + 3])
    seed = torch.tensor([(7 << 32) + 11])
    for c, bits in zip(counter.tolist(), twa.philox_bits(counter, seed)):
        want = twa.philox4x32(*t(c & 0xffffffff, c >> 32, 0, 0, 11, 7))[0]
        assert int(bits) == int(want)


@pytest.mark.parametrize('rate', [0.1, 0.4])
def test_dropout_keep_rate_and_seed(rate):
    q, k, v, _, bias_e = _inputs(8, 4, 32, w=4, seed=5)
    thresh, mult = twa._dropout_consts(rate, torch.float32)
    total = 4 * 8 * 32 * 32
    bits = twa.philox_bits(torch.arange(total), torch.tensor([123]))
    kept = (bits < thresh).double().mean().item()
    # 32768 Bernoulli(1 - rate) draws: within 5 standard deviations
    sigma = (rate * (1 - rate) / total) ** 0.5
    assert abs(kept - (1 - rate)) < 5 * sigma, kept
    assert mult == pytest.approx(1 / (1 - rate), rel=1e-7)
    out1 = _port(q, k, v, bias_e, 8, rate=rate, seed=123)
    out2 = _port(q, k, v, bias_e, 8, rate=rate, seed=123)
    out3 = _port(q, k, v, bias_e, 8, rate=rate, seed=124)
    nodrop = _port(q, k, v, bias_e, 8)
    assert torch.equal(out1, out2)
    assert not torch.allclose(out1, out3)
    assert not torch.allclose(out1, nodrop)


def test_dropout_backward_reuses_the_forward_mask():
    """The gradient along v at rate 0.4 against a central difference, in
    f64 (``tests/test_ops/test_window_attention.py:578``)."""
    q, k, v, _, bias_e = _inputs(2, 4, 8, w=2, seed=2)
    q, k, v, bias_e = (torch.from_numpy(a).double() for a in
                       (q, k, v, bias_e))
    seed = torch.tensor([11])

    def f(v_):
        return twa.window_attention(q, k, v_, bias_e, seed, 2, 2 ** -0.5,
                                    0.4).sum()

    vv = v.clone().requires_grad_(True)
    f(vv).backward()
    dv = torch.from_numpy(np.random.RandomState(0).randn(*v.shape))
    eps = 1e-6
    fd = (f(v + eps * dv) - f(v - eps * dv)) / (2 * eps)
    torch.testing.assert_close((vv.grad * dv).sum(), fd, rtol=1e-7,
                               atol=1e-9)
    # the same along q, where the mask enters through the softmax backward
    qq = q.clone().requires_grad_(True)
    g = twa.window_attention(qq, k, v, bias_e, seed, 2, 2 ** -0.5, 0.4)
    g.sum().backward()
    dq = torch.from_numpy(np.random.RandomState(1).randn(*q.shape))

    def fq(q_):
        return twa.window_attention(q_, k, v, bias_e, seed, 2, 2 ** -0.5,
                                    0.4).sum()

    fd_q = (fq(q + eps * dq) - fq(q - eps * dq)) / (2 * eps)
    torch.testing.assert_close((qq.grad * dq).sum(), fd_q, rtol=1e-6,
                               atol=1e-8)


def test_cpu_counts_no_launch_and_the_kernel_checks_its_inputs():
    """CPU tensors take the plain versions and count nothing. The kernel
    path's checks run before any build: a head width it has no
    instantiation for, or q, k, v with different row strides, raise."""
    before = (twa.window_attention.launches,
              twa.window_attention_backward.launches)
    q, k, v, _, bias_e = _inputs(2, 4, 8, w=2)
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    twa.window_attention(*t, torch.from_numpy(bias_e), torch.zeros(
        1, dtype=torch.int64), 2, 0.5).sum().backward()
    assert (twa.window_attention.launches,
            twa.window_attention_backward.launches) == before
    seed = torch.zeros(1, dtype=torch.int64)
    qkv = torch.randn(2, 8, 24)
    assert twa._kernel_args(qkv[..., :8], qkv[..., 8:16], qkv[..., 16:],
                            torch.from_numpy(bias_e), seed, 2, 0.5,
                            0.0)[0] == (0, 2, 8, 2, 4, 24)
    with pytest.raises(ValueError, match='row stride'):
        twa._kernel_args(qkv[..., :8], torch.from_numpy(k), qkv[..., 16:],
                         torch.from_numpy(bias_e), seed, 2, 0.5, 0.0)
    wide = torch.randn(2, 8, 64)
    with pytest.raises(ValueError, match='head dim 32'):
        twa._kernel_args(wide, wide, wide, torch.zeros(8, 16), seed, 2,
                         0.5, 0.0)
    assert twa.bwd_chunks(2048) == (64, 32) and twa.bwd_chunks(100) == \
        (50, 2) and twa.bwd_chunks(3) == (3, 1)
