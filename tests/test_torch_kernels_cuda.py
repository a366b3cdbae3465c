"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and ``nvcc`` (the kernels have no CPU
mode); without a card they skip. The file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1's and K2b's f32 sums are taken in another order than
``torch.sum`` (rtol 1e-5, atol 1e-4) and are bit-identical from run to
run; K2 rounds as the plain version does (f32 rtol/atol 1e-6, bf16
exact).
"""
import pytest
import torch

from stc_unet_tpu_torch.ops import coordatt_fused as tfused

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
