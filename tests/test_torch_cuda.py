"""K1's CUDA kernel on the card against its plain PyTorch version.

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from adaprox_tpu_torch.ops import kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is a CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _inputs(dev, m, n, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = (torch.randn(m, n, generator=gen, device=dev) / n**0.5).to(dtype)
    b = torch.randn(m, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    return a, b, x


@pytest.mark.parametrize("m,n", [(1, 1), (7, 5), (1000, 300), (999, 301), (4000, 1024),
                                 (517, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_on_card(dev, m, n, dtype):
    a, b, x = _inputs(dev, m, n, dtype)
    before = tk.fused_ls_value_grad.launches
    f, g = tk.fused_ls_value_grad(a, b, x)
    torch.cuda.synchronize()
    assert tk.fused_ls_value_grad.launches == before + 1
    assert f.dtype == torch.float32 and g.shape == (n,) and g.device == a.device
    f_p, g_p = tk.ls_value_grad_plain(a, b, x)  # bf16: the same values upcast
    # f32 FMAs in another summation order than cuBLAS: ~sqrt(n) * 6e-8
    assert abs(float(f - f_p)) <= 1e-5 * abs(float(f_p))
    assert float((g - g_p).abs().max()) <= 1e-5 * float(g_p.abs().max())


def test_k1_is_repeatable_bit_for_bit(dev):
    """No atomics: the adaptive rules feed on gradient differences, so two
    calls on the same inputs must give the same bits."""
    a, b, x = _inputs(dev, 3000, 777, torch.float32, seed=1)
    f1, g1 = tk.fused_ls_value_grad(a, b, x)
    f2, g2 = tk.fused_ls_value_grad(a, b, x)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)


def test_k1_unaligned_view_takes_scalar_loads(dev):
    """A view one element into a buffer is not 16-byte aligned: the wrapper
    must fall back to the kernel's scalar loads, not misread."""
    a, b, x = _inputs(dev, 64, 128, torch.float32, seed=2)
    x_buf = torch.cat([torch.zeros(1, device=dev), x])
    f, g = tk.fused_ls_value_grad(a, b, x_buf[1:])
    f_p, g_p = tk.ls_value_grad_plain(a, b, x)
    assert float((g - g_p).abs().max()) <= 1e-5 * float(g_p.abs().max())
    assert abs(float(f - f_p)) <= 1e-5 * abs(float(f_p))


def test_k1_rejects_what_it_does_not_take(dev):
    a, b, x = _inputs(dev, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.fused_ls_value_grad(a.double(), b, x)  # f64 stays on the CPU
    with pytest.raises(TypeError, match="float32 b and x"):
        tk.fused_ls_value_grad(a, b.double(), x)
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_ls_value_grad(a.t().contiguous().t(), b, x)
    with pytest.raises(ValueError, match="different devices"):
        tk.fused_ls_value_grad(a, b.cpu(), x)
