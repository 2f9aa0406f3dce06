"""The CUDA kernels K1 and K2 on the card against their plain PyTorch versions.

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from adaprox_tpu_torch.ops import kernels as tk
from adaprox_tpu_torch.ops import resident as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 are CUDA kernels; no interpret mode)")
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


# -- K2, the whole-solve kernel ------------------------------------------------------

# (999, 301): ragged rows and columns, so both matvecs take scalar loads
K2_SHAPES = [(64, 128), (1000, 300), (999, 301), (4096, 1024), (8, 524288), (32768, 128)]
K2_PAIRS = [("adapgm", "l1"), ("mm", "l1"), ("fixed", "l1"), ("adapgm", "box"),
            ("adapgm", "elastic"), ("adapgm", "zero")]


def k2_case(dev, m, n, dtype, rule, prox, maxit, seed=0):
    """One solve through K2 and through its plain version on the card, from
    the same inputs (bf16: the same values upcast). tol 0, record mode."""
    a, b, _ = _inputs(dev, m, n, torch.float32, seed)
    lam = 0.1 * float((a.t() @ b).abs().max())
    gamma0 = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    p1, p2 = {"l1": (lam, 0.0), "box": (-0.1, 0.1), "elastic": (lam, 0.5),
              "zero": (0.0, 0.0)}[prox]
    a = a.to(dtype)
    x0 = torch.zeros(n, device=dev)
    kw = dict(prox_kind=prox, p1=p1, p2=p2, rule_kind=rule, record=True)
    before = tr.resident_adapgm.launches
    got = tr.resident_adapgm(a, b, x0, gamma0, 0.0, maxit, **kw)
    torch.cuda.synchronize()
    assert tr.resident_adapgm.launches == before + 1
    return got, tr.resident_adapgm_plain(a, b, x0, gamma0, 0.0, maxit, **kw)


def _rows_close(got, want, horizon, rtol):
    """Each history row within rtol of the plain row's largest magnitude over
    the horizon: near convergence norm_res and the curvature terms are
    differences of nearly equal f32 numbers, so a per-element relative error
    says nothing there."""
    for k, name in zip(range(4, 7), ("gamma", "norm_res", "objective")):
        u, w = got[k][:horizon], want[k][:horizon]
        err = float((u - w).abs().max())
        assert err <= rtol * float(w.abs().max()), (name, err)


# Calibrated on an H100 over every case below: the fixed rule does not amplify
# rounding, and over 30 iterations its rows and x stayed within 2.2e-7 of the
# plain version's scale (gamma exact). The adaptive rules amplify the f32
# summation-order difference (cuBLAS gemv vs the warp dot product) through the
# curvature ratios, so they are held over 3 iterations (both buffer parities
# and the return to the first), where the worst case measured 1.4e-4 (rows)
# and 8.9e-6 (x, of max|x|). A wrong index or a lost term gives errors of order 1.
@pytest.mark.parametrize("rule,prox", K2_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", K2_SHAPES)
def test_k2_matches_plain_on_card(dev, m, n, dtype, rule, prox):
    maxit, rtol, xtol = (30, 1e-5, 1e-5) if rule == "fixed" else (3, 1e-3, 1e-4)
    got, want = k2_case(dev, m, n, dtype, rule, prox, maxit)
    assert got[0].shape == (n,) and got[0].dtype == torch.float32
    assert int(got[1]) == int(want[1]) == maxit and bool(got[3]) == bool(want[3])
    assert all(h.shape == (maxit,) for h in got[4:])
    _rows_close(got, want, maxit, rtol)
    if rule == "fixed":
        assert torch.equal(got[4], want[4])
    assert float((got[0] - want[0]).abs().max()) <= xtol * float(want[0].abs().max())


def test_k2_zero_iterations_on_card(dev):
    got, want = k2_case(dev, 1000, 300, torch.float32, "adapgm", "l1", 0)
    assert int(got[1]) == 0 and float(got[2]) == float("inf") and not bool(got[3])
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())


def test_k2_is_repeatable_bit_for_bit(dev):
    """No atomics, and every CTA sums the partials in one fixed order: two
    launches on the same inputs give the same bits, histories included."""
    a, b, _ = _inputs(dev, 1000, 300, torch.float32, seed=3)
    x0 = torch.zeros(300, device=dev)
    runs = [tr.resident_adapgm(a, b, x0, 0.05, 1e-5, 2000, p1=0.1, record=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(*runs))
    assert bool(runs[0][3])  # it converged, so the early exit ran too


def test_k2_unaligned_view_takes_scalar_loads(dev):
    """A one element into a buffer is contiguous but not 16-byte aligned: the
    wrapper must take the kernel's scalar loads for its rows, not misread.
    Scalar and vector loads give each lane other elements, so the sums run in
    another order: held to the plain version at the fixed rule's tolerance."""
    a, b, _ = _inputs(dev, 64, 128, torch.float32, seed=2)
    buf = torch.cat([torch.zeros(1, device=dev), a.flatten()])
    x0 = torch.zeros(128, device=dev)
    kw = dict(p1=0.1, rule_kind="fixed", record=True)
    got = tr.resident_adapgm(buf[1:].view(64, 128), b, x0, 0.5, 0.0, 30, **kw)
    want = tr.resident_adapgm_plain(a, b, x0, 0.5, 0.0, 30, **kw)
    _rows_close(got, want, 30, 1e-5)
    assert float((got[0] - want[0]).abs().max()) <= 1e-5 * float(want[0].abs().max())


def test_k2_counts_one_launch_a_solve(dev):
    a, b, x = _inputs(dev, 64, 128, torch.float32)
    before = tr.resident_adapgm.launches
    tr.resident_adapgm_l1(a, b, torch.zeros_like(x), 0.1, 0.1, 0.0, 5)
    tr.resident_adapgm(a, b, torch.zeros_like(x), 0.1, 0.0, 5, rule_kind="mm", record=True)
    assert tr.resident_adapgm.launches == before + 2


def test_lasso_resident_sends_every_shape_to_k2_on_card(dev, tmp_path, capsys):
    """7000x1000 pads to 7000x1024 f32, 28.7 MB: past the JAX driver's
    routing limit (24 MiB), which the CPU applies, but K2 takes it."""
    from adaprox_tpu_torch.experiments import lasso
    from adaprox_tpu_torch.utils.logging import read_jsonl

    before = tr.resident_adapgm.launches
    lasso.main(["--resident", "--sizes", "7000x1000x10", "--maxit", "5", "--device", "cuda",
                "--outdir", str(tmp_path), "--no-plot"])
    torch.cuda.synchronize()
    assert "falling back" not in capsys.readouterr().out
    assert tr.resident_adapgm.launches == before + 3
    assert read_jsonl(tmp_path / "lasso_7000_1000_10.jsonl")[-1]["fast_path"] == "resident"


def test_k2_rejects_what_it_does_not_take(dev):
    a, b, x = _inputs(dev, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tr.resident_adapgm(a.double(), b, x, 0.1, 0.0, 3)  # f64 stays on the CPU
    with pytest.raises(TypeError, match="float32 b and x0"):
        tr.resident_adapgm(a, b.double(), x, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tr.resident_adapgm(a.t().contiguous().t(), b, x, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="different devices"):
        tr.resident_adapgm(a, b.cpu(), x, 0.1, 0.0, 3)
