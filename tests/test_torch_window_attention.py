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
the Random123 test vectors), each call's four words land on the four
elements the draw map names, the keep rate is within binomial bounds, a
seed gives one output, and the gradient along v at rate 0.4 matches a
finite difference in f64, which holds only if the backward draws the
forward's mask.

The card's kernels run their products on the tensor cores. Their numerics
are emulated in numpy here (exact bf16 or TF32 products, each MMA step of
eight of them added to an f32 accumulator and rounded toward zero; 3xTF32
splits for float32) and held to the plain version at the card check's
limits, at MaxViT's four stage shapes.
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
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

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
    # philox_words, which the draw map takes its words from, is the four
    # words at (counter lo, counter hi, 0, 0)
    counter = torch.tensor([0, 5, 2 ** 40 + 3])
    seed = torch.tensor([(7 << 32) + 11])
    words = twa.philox_words(counter, seed)
    for i, c in enumerate(counter.tolist()):
        want = twa.philox4x32(*t(c & 0xffffffff, c >> 32, 0, 0, 11, 7))
        assert tuple(int(w[i]) for w in words) == tuple(int(x) for x in want)


@pytest.mark.parametrize('n', [64, 49, 1])
def test_dropout_bits_gives_each_call_four_elements(n):
    """The draw map, by exact equality: the four words of the Philox call
    at counter (w·H + h)·1024 + (n0 >> 4)·256 + (n0 & 7)·32 +
    (m0 >> 3)·4 + ((m0 >> 1) & 3), for n0 mod 16 < 8 and m0 even, land on
    elements (n0, m0), (n0, m0 + 1), (n0 + 8, m0), (n0 + 8, m0 + 1) of
    window w, head h; those calls are the 1024 of a window and head, and
    so cover each of its elements once. Past N the elements do not exist."""
    w, h = 2, 3
    bits = twa.dropout_bits((w, h, n, n), torch.tensor([(5 << 32) + 9]))
    assert bits.shape == (w, h, n, n)
    n0, m0 = np.meshgrid([r for r in range(64) if r % 16 < 8],
                         range(0, 64, 2), indexing='ij')
    call = (n0 >> 4) * 256 + (n0 & 7) * 32 + (m0 >> 3) * 4 + ((m0 >> 1) & 3)
    assert sorted(call.ravel().tolist()) == list(range(1024))
    counter = (torch.arange(w * h)[:, None] << 10) + torch.from_numpy(
        call.ravel())
    zero = torch.zeros((), dtype=torch.int64)
    words = twa.philox4x32(counter & 0xffffffff, counter >> 32, zero, zero,
                           torch.tensor(9), torch.tensor(5))
    seen = 0
    for word, (dn, dm) in zip(words, ((0, 0), (0, 1), (8, 0), (8, 1))):
        rows, cols = (n0 + dn).ravel(), (m0 + dm).ravel()
        inside = torch.from_numpy((rows < n) & (cols < n))
        got = bits.reshape(w * h, n, n)[:, rows[inside.numpy()],
                                        cols[inside.numpy()]]
        assert torch.equal(got, word[:, inside])
        seen += int(inside.sum())
    assert seen == n * n


@pytest.mark.parametrize('rate', [0.1, 0.4])
def test_dropout_keep_rate_and_seed(rate):
    q, k, v, _, bias_e = _inputs(8, 4, 32, w=4, seed=5)
    thresh, mult = twa._dropout_consts(rate, torch.float32)
    total = 4 * 8 * 32 * 32
    bits = twa.dropout_bits((4, 8, 32, 32), torch.tensor([123]))
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


def test_launch_scalars_are_computed_once():
    """The kernels' scalars (scale rounded to the type, the dropout's
    threshold, multiplier and switch) come from a cache keyed by (scale,
    rate, dtype), with the values the launch needs."""
    twa._launch_scalars.cache_clear()
    got = twa._launch_scalars(32 ** -0.5, 0.1, torch.bfloat16)
    assert got == (torch.tensor(32 ** -0.5, dtype=torch.bfloat16).item(),
                   *twa._dropout_consts(0.1, torch.bfloat16), 1)
    assert twa._launch_scalars(0.5, 0.0, torch.float32) == (0.5, 0, 1.0, 0)
    twa._launch_scalars(32 ** -0.5, 0.1, torch.bfloat16)
    assert twa._launch_scalars.cache_info().hits == 1


# MaxViT-UNet's four stages: (heads, d, N), 32 heads over 8x8 windows
STAGES = [(32, 2, 64), (32, 4, 64), (32, 8, 64), (32, 16, 64)]


def _bf16(x):
    """x (float32) rounded to bfloat16 to nearest even, as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _tf32(x, nearest=True):
    """x (float32) rounded to TF32 to nearest (ties away from zero), or
    toward zero (the tensor core reading an f32 register as TF32)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if nearest:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(x):
    """x (float64) rounded to float32 toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _mma(a, b, split):
    """a @ b over the last two axes as the kernels' chain of m16n8k8 steps
    sums it: each step adds its eight exact products to the f32
    accumulator and rounds toward zero. With ``split`` (3xTF32) each
    operand is hi = tf32(x) to nearest and lo = x - hi read as TF32, and a
    step is three MMAs, lo·hi, hi·lo, hi·hi, in that order. k is padded
    with zeros to a multiple of 8."""
    pad = -a.shape[-1] % 8
    a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), a.dtype)], -1)
    b = np.concatenate([b, np.zeros(b.shape[:-2] + (pad, b.shape[-1]),
                                    b.dtype)], -2)
    if split:
        ah, bh = _tf32(a), _tf32(b)
        terms = [(_tf32(a - ah, False), bh), (ah, _tf32(b - bh, False)),
                 (ah, bh)]
    else:
        terms = [(a, b)]
    terms = [(x.astype(np.float64), y.astype(np.float64)) for x, y in terms]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _toward_zero(acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :])
    return acc


def _kernel_model(q, k, v, bias_e, do, heads, bf16, split):
    """The card kernels' arithmetic on (W, N, C) float32 arrays (bf16 values
    when ``bf16``): out, dq, dk, dv and dbias (N, heads·N), rate 0."""
    rnd = _bf16 if bf16 else (lambda x: x.astype(np.float32))
    w, n, c = q.shape
    scale = np.float32(heads ** -0.5)

    def heads_of(x):
        return x.reshape(w, n, heads, c // heads).transpose(0, 2, 1, 3)

    def merge(x):
        return x.transpose(0, 2, 1, 3).reshape(w, n, c)

    def mma(a, b):
        return _mma(a, b, split)

    qs = rnd(heads_of(q) * rnd(scale))
    kh, vh, doh = heads_of(k), heads_of(v), heads_of(do)
    bias = bias_e.reshape(n, heads, n).transpose(1, 0, 2)
    x = mma(qs, kh.swapaxes(-1, -2)) + bias
    e = np.exp(x - x.max(-1, keepdims=True))
    attn = e * (np.float32(1) / e.sum(-1, keepdims=True))
    p = rnd(attn)
    out = rnd(mma(p, vh))
    t = mma(doh, vh.swapaxes(-1, -2)) * attn
    ds = t - attn * t.sum(-1, keepdims=True)
    dbias = ds.sum(0).transpose(1, 0, 2).reshape(n, heads * n)
    dsr = rnd(ds)
    dq = rnd(mma(dsr, kh) * scale)
    dk = rnd(mma(dsr.swapaxes(-1, -2), qs))
    dv = rnd(mma(p.swapaxes(-1, -2), doh))
    return [merge(out), merge(dq), merge(dk), merge(dv), dbias]


def _plain(q, k, v, bias_e, do, heads, dtype):
    """The plain versions' out, dq, dk, dv and dbias, as float32 numpy."""
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
    seed = torch.zeros(1, dtype=torch.int64)
    out = twa.window_attention_reference(t[0], t[1], t[2],
                                         torch.from_numpy(bias_e), seed,
                                         heads, heads ** -0.5)
    grads = twa.window_attention_backward_reference(
        t[0], t[1], t[2], torch.from_numpy(bias_e), seed, t[3], heads,
        heads ** -0.5)
    return [x.float().numpy() for x in (out,) + grads]


def _within(got, want, rtol, atol_share):
    """|got - want| <= rtol |want| + atol_share max |want|, everywhere."""
    return bool(np.all(np.abs(got - want) <= rtol * np.abs(want) +
                       atol_share * np.abs(want).max()))


@pytest.mark.parametrize('heads,d,n', STAGES)
def test_bf16_mma_numerics_stay_within_the_card_limits(heads, d, n):
    """The bf16 kernels' arithmetic, emulated, against the plain version
    in bf16 at each MaxViT stage (W = 2): out, dq, dk and dv within the
    card check's bf16 limits (rtol 2^-7, atol 2^-7 of the largest value),
    dbias within its f32 ones (rtol 1e-4, atol 1e-5 of the largest)."""
    q, k, v, _, bias_e = _inputs(heads, d, n, w=2, seed=20 + d)
    do = np.random.RandomState(30 + d).randn(*q.shape).astype(np.float32)
    q, k, v, do = (_bf16(a) for a in (q, k, v, do))
    model = _kernel_model(q, k, v, bias_e, do, heads, True, False)
    plain = _plain(q, k, v, bias_e, do, heads, torch.bfloat16)
    for name, got, want in zip(('out', 'dq', 'dk', 'dv', 'dbias'), model,
                               plain):
        tol = (1e-4, 1e-5) if name == 'dbias' else (2 ** -7, 2 ** -7)
        assert _within(got, want, *tol), name


@pytest.mark.parametrize('heads,d,n', [(32, 16, 64), (2, 16, 64)])
def test_f32_tf32_split_keeps_window_attention_at_f32_accuracy(heads, d, n):
    """The float32 kernels' 3xTF32 products, emulated, against the plain
    version in f32 at d = 16, N = 64 (W = 2): every output within the card
    check's f32 limits (rtol 1e-4, atol 1e-5 of the largest value). One
    TF32 pass, without the split, misses them."""
    q, k, v, _, bias_e = _inputs(heads, d, n, w=2, seed=40 + heads)
    do = np.random.RandomState(41).randn(*q.shape).astype(np.float32)
    plain = _plain(q, k, v, bias_e, do, heads, torch.float32)
    for name, got, want in zip(('out', 'dq', 'dk', 'dv', 'dbias'),
                               _kernel_model(q, k, v, bias_e, do, heads,
                                             False, True), plain):
        assert _within(got, want, 1e-4, 1e-5), name
    one_pass = _kernel_model(*(_tf32(a) for a in (q, k, v)), bias_e,
                             _tf32(do), heads, False, False)
    assert not all(_within(got, want, 1e-4, 1e-5)
                   for got, want in zip(one_pass, plain))


# -- the ablation probe of K3f and K3b ----------------------------------------

def test_window_attention_probe_needs_a_card(monkeypatch, capsys):
    """The ablation probe builds and times on the card only: without CUDA
    it exits 1 and prints no record."""
    from stc_unet_tpu_torch.tools import probe_window_attention
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert probe_window_attention.main([]) == 1
    assert capsys.readouterr().out == ''
    with pytest.raises(RuntimeError, match='CUDA card'):
        probe_window_attention.probe()


@pytest.mark.parametrize('variant', ['base', 'no_philox', 'no_exp',
                                     'no_phase2', 'blocks_8192',
                                     'blocks_1024', 'bounds_5_4'])
def test_window_attention_probe_edits_apply_to_the_source(variant):
    """Each variant's edits match the kernel source as often as they
    should, only ``base`` leaves it as it is, and every edit keeps the
    source's braces and parentheses balanced."""
    from stc_unet_tpu_torch.ops import _build
    from stc_unet_tpu_torch.tools import probe_window_attention
    source = (_build.SRC_DIR / 'window_attention.cu').read_text()
    edited = probe_window_attention.variant_source(variant, source)
    assert (edited == source) == (variant == 'base')
    for a, b in ('{}', '()'):
        assert edited.count(a) - edited.count(b) == \
            source.count(a) - source.count(b)


def test_window_attention_probe_reads_ptxas():
    """The probe's registers and spills of each K3 build, from nvcc's
    ptxas lines, named by kernel, type and head width; other kernels are
    left out."""
    from stc_unet_tpu_torch.tools import probe_window_attention
    fwd = '_ZN12_GLOBAL__N_16wa_fwdI13__nv_bfloat16Li2EEEvPKT_S4_S4_PKfPKl'
    bwd32 = '_ZN12_GLOBAL__N_16wa_bwdIfLi16EEEvPKT_S3_S3_PKfPKl'
    log = '\n'.join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f'ptxas info    : Function properties for {fwd}',
        '    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads',
        'ptxas info    : Used 96 registers, used 1 barriers',
        f"ptxas info    : Compiling entry function '{bwd32}' for 'sm_90a'",
        'ptxas info    : Used 238 registers, used 1 barriers',
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112wa_dbias"
        "_sumEPKfPfii' for 'sm_90a'",
        'ptxas info    : Used 32 registers, used 0 barriers'])
    assert probe_window_attention.ptxas_usage(log) == {
        'wa_fwd<bf16, 2>': {'spill_bytes': 16, 'registers': 96},
        'wa_bwd<f32, 16>': {'registers': 238}}
