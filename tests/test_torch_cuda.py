"""The CUDA kernels K1, K2, K2b, K2c, K3, K4, K4b, K4's aGRAAL core, K6a, K6b, K6c, K6d,
K7a, K7b, K7c, K7d, K5, K8, K9a, K9b and K10a-c on the card against their plain PyTorch
versions (K2, K2b, K2c, K4, K4b and aGRAAL with the least-squares, logistic and cubic
objectives; K6a-K6d with the dual SVM's dense Q or factored B, K6a-K6c on thread-block
clusters with their layouts, the rows reversed and two waves of rows; K7a's two cores, their
dataset grids K7b, K7c and K7d with the square-root lasso's and the least absolute
deviation's h; K8 under ELLOperator and K9a/K9b under BCSROperator in the engine; the
stream probes K10a-c).

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import ctypes
import math
import subprocess

import pytest
import torch

from adaprox_tpu_torch.experiments.k7a_calibration import (K7A_HORIZON, K7A_RTOL, K7A_TS,
                                                           K7A_X_RTOL)
from adaprox_tpu_torch.ops import kernels as tk
from adaprox_tpu_torch.ops import resident as tr
from adaprox_tpu_torch.ops import resident_bt as trb
from adaprox_tpu_torch.utils.profiling import chip_bandwidth_gbps, flushed_ms, timed

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1, K2, K2c, K3, K4, K4b and aGRAAL are CUDA "
                    "kernels; no interpret mode)")
    return torch.device("cuda")


def _inputs(dev, m, n, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = (torch.randn(m, n, generator=gen, device=dev) / n**0.5).to(dtype)
    b = torch.randn(m, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    return a, b, x


# K1's plan (ops/kernels.py::k1_plan) across its thresholds: the rows kernel up to n = 1024 and
# one 16-byte vector past it (1028 f32, 1032 bf16), the ring kernel to 16384 columns a CTA and
# one vector past it (a cluster of 2), up to 131072 (a cluster of 8); m = 1, m below the SM
# count, ragged m and n (element loads).
K1_SHAPES = [(1, 1), (7, 5), (1000, 300), (999, 301), (4000, 1024), (517, 2048), (64, 1028),
             (64, 1032), (1, 1030), (100, 4096), (1001, 1027), (31, 16384), (3, 16388),
             (1, 16392), (37, 20001), (9, 131072)]


@pytest.mark.parametrize("m,n", K1_SHAPES)
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


def _k1_plan(a):
    return tk.k1_plan(*a.shape, a.element_size(),
                      torch.cuda.get_device_properties(a.device).multi_processor_count)


@pytest.mark.parametrize("m,n,dtype", [(4000, 1024, torch.float32), (999, 301, torch.bfloat16),
                                       (517, 2048, torch.float32),
                                       (200, 16384, torch.bfloat16),
                                       (37, 20001, torch.float32)])
def test_k1_smaller_grid_gives_the_same_bits(dev, m, n, dtype):
    """The slots and their rows follow from the shape alone: one CTA (or cluster), or three,
    taking every slot in turn gives the plan's grid's bits."""
    a, b, x = _inputs(dev, m, n, dtype, seed=4)
    plan = _k1_plan(a)
    assert plan["grid"] > 3 * plan["cluster"] or plan["slots"] <= 3
    want = tk._k1_launch(a, b, x, plan)
    for clusters in (1, 3):
        got = tk._k1_launch(a, b, x, dict(plan, grid=clusters * plan["cluster"]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,n,dtype", [(4000, 1028, torch.float32), (200, 16384, torch.bfloat16),
                                       (37, 20001, torch.bfloat16)])
def test_k1_ring_depth_leaves_the_bits(dev, m, n, dtype):
    """A deep ring or one of two slots: each row's dot and update are the same arithmetic in
    the same order, so the same bits."""
    a, b, x = _inputs(dev, m, n, dtype, seed=7)
    plan = _k1_plan(a)
    assert plan["regime"] == "ring" and plan["stages"] > 3
    want = tk._k1_launch(a, b, x, plan)
    for stages in (2, 3):
        got = tk._k1_launch(a, b, x, dict(plan, stages=stages, smem=stages * plan["stride"]))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,n", [(1000, 300), (517, 2048), (37, 20000)])
def test_k1_bits_do_not_depend_on_alignment(dev, m, n):
    """A view of A one element into a buffer takes element loads (and, in the ring kernel, a
    copy from the 16-byte unit below each row) where the aligned copy takes 16-byte ones: the
    same values in the same order, so the same bits."""
    a, b, x = _inputs(dev, m, n, torch.float32, seed=5)
    buf = torch.empty(m * n + 1, device=dev)
    buf[1:] = a.reshape(-1)
    view = buf[1:].view(m, n)
    assert view.data_ptr() % 16 and a.data_ptr() % 16 == 0
    f1, g1 = tk.fused_ls_value_grad(a, b, x)
    f2, g2 = tk.fused_ls_value_grad(view, b, x)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)


@pytest.mark.parametrize("m,n", [(999, 301), (517, 2048)])
def test_k1_check_fails_a_kernel_that_drops_a_row(dev, tmp_path, monkeypatch, m, n):
    """The plain comparison catches a K1 that drops the last row of the last (ragged) slot:
    built from a copy of csrc/ with one line changed, it fails where K1 as built passes."""
    import shutil

    src = tk.SOURCE.read_text()
    line = "  *r1 = end < p.m ? end : p.m;\n"
    assert src.count(line) == 1
    for header in tk.SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, tmp_path / header.name)
    mutant = tmp_path / "fused_ls_drop_last_row.cu"
    mutant.write_text(src.replace(line, line.replace(": p.m;", ": p.m - 1;")))
    a, b, x = _inputs(dev, m, n, torch.float32, seed=6)
    assert (_k1_plan(a)["regime"] == "rows") == (n <= tk.K1_NARROW_N)
    f_p, g_p = tk.ls_value_grad_plain(a, b, x)

    def err(f, g):
        return max(abs(float(f - f_p)) / abs(float(f_p)),
                   float((g - g_p).abs().max()) / float(g_p.abs().max()))

    assert err(*tk.fused_ls_value_grad(a, b, x)) <= 1e-5
    monkeypatch.setattr(tk, "SOURCE", mutant)
    got = tk.fused_ls_value_grad(a, b, x)
    torch.cuda.synchronize()
    assert err(*got) > 1e-5


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
    wide = torch.zeros(1, 131076, device=dev)
    with pytest.raises(ValueError, match="on chip"):
        tk.fused_ls_value_grad(wide, b[:1], torch.zeros(131076, device=dev))


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


def _rows_close(got, want, horizon, rtol, residual_noise=0.0):
    """Each history row within rtol of the plain row's largest magnitude over
    the horizon: near convergence norm_res and the curvature terms are
    differences of nearly equal f32 numbers, so a per-element relative error
    says nothing there. ``residual_noise`` is the rounding scale d of the
    residual r = A x - b: an error d in r moves the objective |r|^2/2 by
    |r| d = sqrt(2 F) d, which the objective row is allowed on top."""
    for k, name in zip(range(4, 7), ("gamma", "norm_res", "objective")):
        u, w = got[k][:horizon], want[k][:horizon]
        allow = rtol * float(w.abs().max())
        if name == "objective":
            allow = allow + residual_noise * (2 * w.abs()).sqrt()
        assert bool(((u - w).abs() <= allow).all()), (name, float((u - w).abs().max()))


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


def test_lasso_resident_sends_every_shape_to_k2c_on_card(dev, tmp_path, capsys):
    """7000x1000 pads to 7000x1024 f32, 28.7 MB: past the JAX driver's
    routing limit (24 MiB), which the CPU applies, but K2c, K4b and K4's aGRAAL
    core take it. The four rule rows are one K2c launch, the four backtracking
    rows one K4b launch and aGRAAL one launch: no K2, K4 or K1 launch."""
    from adaprox_tpu_torch.experiments import lasso
    from adaprox_tpu_torch.utils.logging import read_jsonl

    counters = (tk.fused_ls_value_grad, tr.resident_adapgm, tr.resident_rule_sweep,
                trb.resident_backtracking, trb.resident_bt_sweep, trb.resident_agraal)
    before = [c.launches for c in counters]
    lasso.main(["--resident", "--sizes", "7000x1000x10", "--maxit", "5", "--device", "cuda",
                "--outdir", str(tmp_path), "--no-plot"])
    torch.cuda.synchronize()
    assert "falling back" not in capsys.readouterr().out
    assert [c.launches - k for c, k in zip(counters, before)] == [0, 0, 1, 0, 1, 1]
    rows = read_jsonl(tmp_path / "lasso_7000_1000_10.jsonl")
    assert rows[-1]["fast_path"] == "resident" and list(rows[-2]) == ["grid_total_s"]
    assert len({r["method"] for r in rows if r.get("method")}) == 9


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


# -- K2's momentum body and K2c, the rule sweep ---------------------------------------

# Calibrated on an H100: the momentum body keeps the fixed step, so it does not
# amplify the f32 summation-order difference the way the adaptive rules do;
# over 30 iterations its rows and x are held at the fixed rule's tolerance.
# Where the problem interpolates (the zero and box prox at m < n), the
# objective row falls from 1.1e-4 to 1e-14 within 30 iterations at 8x524288,
# and what is left of it is the f32 rounding of the residual: there the kernel
# and cuBLAS differed by 1.9e-9 in the objective while x, gamma and norm_res
# agreed. So the objective row is allowed sqrt(2 F) d on top, with d =
# eps_f32 sqrt(n) |b|, the rounding scale of an n-term f32 dot product of
# size |b|.
MOMENTUM_RTOL = 1e-5


@pytest.mark.parametrize("prox", ["l1", "elastic", "zero", "box"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", K2_SHAPES)
def test_k2_momentum_matches_plain_on_card(dev, m, n, dtype, prox):
    a, b, _ = _inputs(dev, m, n, torch.float32)
    lam = 0.1 * float((a.t() @ b).abs().max())
    gamma0 = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    a = a.to(dtype)
    x0 = torch.zeros(n, device=dev)
    p1, p2 = {"l1": (lam, 0.0), "elastic": (lam, 0.5), "zero": (0.0, 0.0),
              "box": (-0.1, 0.1)}[prox]
    kw = dict(prox_kind=prox, p1=p1, p2=p2, momentum=True, record=True)
    before = tr.resident_adapgm.launches
    got = tr.resident_adapgm(a, b, x0, gamma0, 0.0, 30, **kw)
    torch.cuda.synchronize()
    assert tr.resident_adapgm.launches == before + 1
    want = tr.resident_adapgm_plain(a, b, x0, gamma0, 0.0, 30, **kw)
    assert int(got[1]) == int(want[1]) == 30 and torch.equal(got[4], want[4])
    noise = torch.finfo(torch.float32).eps * n**0.5 * float(b.norm())
    _rows_close(got, want, 30, MOMENTUM_RTOL, residual_noise=noise)
    assert float((got[0] - want[0]).abs().max()) <= MOMENTUM_RTOL * float(want[0].abs().max())
    # without record mode: the same solve, the same bits
    plain = tr.resident_adapgm(a, b, x0, gamma0, 0.0, 30, **dict(kw, record=False))
    assert all(torch.equal(u, w) for u, w in zip(plain, got[:4]))


def sweep_case(dev, m, n, dtype, seed=0):
    """The lasso menu's four rows (tol 1e-5, one with a cap under maxit) and a
    momentum row with another tol, on one problem."""
    a, b, _ = _inputs(dev, m, n, torch.float32, seed)
    lam = 0.1 * float((a.t() @ b).abs().max())
    gam = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    specs = [(gam, "fixed", False, 1e-5, 150), (gam, "fixed", True, 1e-5, 400),
             (gam, "mm", False, 1e-5, 400), (gam, "adapgm", False, 1e-5, 400),
             (2 * gam, "adapgm", False, 0.0, 37), (gam, "fixed", True, 1e-3, 400)]
    return a.to(dtype), b, torch.zeros(n, device=dev), specs, lam


def _bits(t):
    """A tensor's bits: float32 as int32 (torch.equal takes NaN != NaN and -0 == 0)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _k2c_problem(dev, problem, dtype):
    """(A in ``dtype``, b, x0, gamma0, the sweep's keywords) of a K2c card case: least
    squares (l1, lam a tenth of |A'b|_inf, gamma0 1/||A||^2) at "ls MxN", mushrooms' [X 1]
    shape with the logistic objective ("logreg 8128x128"), or the cubic model of a logistic
    Hessian, c = 1 ("cubic 128": 113 coordinates padded to 128; "cubic 301")."""
    kind, shape = problem.split()
    if kind == "logreg":
        a, b, gam = logreg_problem(dev, 8124, 112, 8128, 128, seed=4)
        kw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=8124.0)
    elif kind == "cubic":
        n = int(shape)
        a, b, gam = cubic_problem(dev, 113 if n == 128 else n, n, 1.0, seed=4)
        kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)
    else:
        m, n = map(int, shape.split("x"))
        a, b, _ = _inputs(dev, m, n, torch.float32)
        gam = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
        kw = dict(p1=0.1 * float((a.t() @ b).abs().max()))
    return a.to(dtype), b, torch.zeros(a.shape[1], device=dev), gam, kw


# K2c's card table: rule and momentum rows, a cap under maxit, tol 0 (runs to its cap), a cap
# of 0, tol inf (stops before its first iteration), gamma0 NaN (a NaN residual at its first
# check stops it) and a momentum row at a smaller step; longer tables cycle through them with
# larger steps. maxit K2C_MAXIT.
K2C_MAXIT = 400
K2C_BASE = [(1.0, "fixed", False, 1e-5, 150), (1.0, "fixed", True, 1e-5, 400),
            (1.0, "mm", False, 1e-5, 400), (1.0, "adapgm", False, 1e-5, 400),
            (2.0, "adapgm", False, 0.0, 37), (1.0, "fixed", True, 1e-3, 400),
            (1.0, "adapgm", False, 1e-5, 0), (1.0, "mm", False, math.inf, 400),
            (math.nan, "adapgm", False, 1e-5, 400), (0.5, "fixed", True, 1e-4, 300)]
K2C_PROBLEMS = ["ls 4096x1024", "ls 1000x300", "ls 64x128", "logreg 8128x128", "cubic 128",
                "cubic 301"]


def k2c_specs(gam, count):
    """``count`` rows of K2C_BASE in turn, the steps in units of ``gam``, each lap 25% larger."""
    specs = []
    for j in range(count):
        scale, rule, mom, tol, cap = K2C_BASE[j % len(K2C_BASE)]
        specs.append((scale * gam * (1 + 0.25 * (j // len(K2C_BASE))), rule, mom, tol, cap))
    return specs


def _assert_rows_are_k2_launches(a, b, x0, specs, out, **kw):
    """Every row of the sweep ``out`` is the single K2 launch with its arguments, bit for
    bit: x, numit, norm_res, converged and the three histories, which are zero past the cap."""
    xs, its, res, conv, hists = out
    for j, (g0, rule, mom, tol, cap) in enumerate(specs):
        one = tr.resident_adapgm(a, b, x0, g0, tol, cap, rule_kind=rule, momentum=mom,
                                 record=True, **kw)
        torch.cuda.synchronize()
        for k, got in enumerate((xs[j], its[j], res[j], conv[j])):
            assert torch.equal(_bits(got), _bits(one[k])), (j, k)
        for k in range(3):
            assert torch.equal(_bits(hists[k][j][:cap]), _bits(one[4 + k])), (j, k)
            assert not bool(hists[k][j][cap:].any()), (j, k)  # zero past the cap
        assert int(its[j]) <= cap


@pytest.mark.parametrize("count", [1, 4, 6, 8, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("problem", K2C_PROBLEMS)
def test_k2c_rows_equal_single_k2_launches(dev, problem, dtype, count):
    """K2c runs each row on K2's grid in K2's order of every sum: row j of a sweep is the
    single K2 launch with row j's arguments, bit for bit, in one lockstep group (up to 8
    rows) or several (9 and 17), beside rows that stop early, late or never start."""
    a, b, x0, gam, kw = _k2c_problem(dev, problem, dtype)
    specs = k2c_specs(gam, count)
    before = tr.resident_rule_sweep.launches
    out = tr.resident_rule_sweep(a, b, x0, tr.rule_rows(specs), 0.0, K2C_MAXIT, **kw)
    torch.cuda.synchronize()
    assert tr.resident_rule_sweep.launches == before + 1
    n = a.shape[1]
    assert out[0].shape == (count, n) and all(h.shape == (count, K2C_MAXIT) for h in out[4])
    _assert_rows_are_k2_launches(a, b, x0, specs, out, **kw)


def _k2c_flat(out):
    return [*out[:4], *out[4]]


@pytest.mark.parametrize("problem", ["ls 1000x300", "logreg 8128x128", "cubic 128"])
def test_k2c_row_order_within_a_group_leaves_each_row(dev, problem):
    """The eight rows of one group reversed, and rotated by three, give the same rows
    permuted, bit for bit: a row's bits do not depend on its place in its group."""
    a, b, x0, gam, kw = _k2c_problem(dev, problem, torch.float32)
    specs = k2c_specs(gam, 8)
    base = _k2c_flat(tr.resident_rule_sweep(a, b, x0, tr.rule_rows(specs), 0.0, K2C_MAXIT, **kw))
    for order in (list(range(7, -1, -1)), [(j + 3) % 8 for j in range(8)]):
        got = _k2c_flat(tr.resident_rule_sweep(a, b, x0, tr.rule_rows([specs[j] for j in order]),
                                               0.0, K2C_MAXIT, **kw))
        torch.cuda.synchronize()
        for u, w in zip(got, base):
            assert torch.equal(_bits(u), _bits(w[order])), order


def test_k2c_matches_plain_on_card(dev):
    """The sweep against its plain version: 30 iterations a row, held like
    K2's rows (the adaptive rules over 3 iterations)."""
    a, b, x0, _, lam = sweep_case(dev, 1000, 300, torch.float32, seed=4)
    gam = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    specs = [(gam, "fixed", False), (gam, "fixed", True), (gam, "mm", False),
             (gam, "adapgm", False)]
    rows = tr.rule_rows(specs, tol=0.0, maxit=30)
    got = tr.resident_rule_sweep(a, b, x0, rows, 0.0, 30, p1=lam)
    want = tr.resident_rule_sweep_plain(a, b, x0, rows, 30, p1=lam)
    for j, (_, rule, mom) in enumerate(specs):
        horizon, rtol = (30, MOMENTUM_RTOL) if rule == "fixed" else (3, 1e-3)
        row = lambda out: (out[0][j], out[1][j], out[2][j], out[3][j], *(h[j] for h in out[4]))
        _rows_close(row(got), row(want), horizon, rtol)
        if rule == "fixed":
            assert float((got[0][j] - want[0][j]).abs().max()) <= rtol * float(
                want[0][j].abs().max())


def test_k2c_is_repeatable_bit_for_bit(dev):
    a, b, x0, specs, lam = sweep_case(dev, 1000, 300, torch.float32, seed=3)
    runs = [tr.resident_rule_sweep(a, b, x0, tr.rule_rows(specs), 0.0, 400, p1=lam)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(runs[0][:4], runs[1][:4]))
    assert all(torch.equal(u, w) for u, w in zip(runs[0][4], runs[1][4]))


def test_k2c_counts_one_launch_a_sweep(dev):
    a, b, x0, specs, lam = sweep_case(dev, 64, 128, torch.float32)
    before = tr.resident_rule_sweep.launches, tr.resident_adapgm.launches
    for _ in range(2):
        tr.resident_rule_sweep(a, b, x0, tr.rule_rows(specs), 0.0, 400, p1=lam)
    assert (tr.resident_rule_sweep.launches, tr.resident_adapgm.launches) == (
        before[0] + 2, before[1])


def test_k2c_rejects_what_it_does_not_take(dev):
    a, b, x0, specs, _ = sweep_case(dev, 16, 8, torch.float32)
    rows = tr.rule_rows(specs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tr.resident_rule_sweep(a.double(), b, x0, rows, 0.0, 400)  # f64 stays on the CPU
    with pytest.raises(TypeError, match="float32 b and x0"):
        tr.resident_rule_sweep(a, b.double(), x0, rows, 0.0, 400)
    with pytest.raises(ValueError, match=">= 32-bit iterates"):
        tr.resident_rule_sweep(a.half(), b.half(), x0.half(), rows, 0.0, 400)
    with pytest.raises(ValueError, match="cap must be an integer"):
        tr.resident_rule_sweep(a, b, x0, rows, 0.0, 399)  # a cap of 400 is past maxit
    with pytest.raises(ValueError, match="contiguous"):
        tr.resident_rule_sweep(a.t().contiguous().t(), b, x0, rows, 0.0, 400)
    with pytest.raises(ValueError, match="different devices"):
        tr.resident_rule_sweep(a, b.cpu(), x0, rows, 0.0, 400)


# -- K3, the fused logistic oracle ------------------------------------------------------


def _logistic_inputs(dev, m, n, dtype, seed=0):
    """Sparse N(0, 1) features (30% nonzero, like the datasets' synthetic
    stand-ins), labels in {0, 1} from a noisy linear model, and a point
    (w, w_bias) with logits of order 1. The features keep unit entries: with
    unit rows x = 0 would solve the lam 0.01 problems below, and there the
    kernel and its plain version stop at different iterations on rounding
    noise."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(m, n, generator=gen, device=dev)
    x = x * (torch.rand(m, n, generator=gen, device=dev) < 0.3)
    scale = 1.0 / (0.3 * n) ** 0.5
    w_true = scale * torch.randn(n, generator=gen, device=dev)
    y = ((x @ w_true + 0.5 * torch.randn(m, generator=gen, device=dev)) > 0).float()
    w = scale * torch.randn(n, generator=gen, device=dev)
    return x.to(dtype), y, w, torch.tensor(0.3, device=dev)


# the datasets' [X] shapes as the drivers meet them, raw and tile-padded (a5a,
# mushrooms, phishing), and ragged ones
K3_SHAPES = [(1, 1), (7, 5), (999, 301), (6414, 123), (6416, 128), (8124, 112), (8128, 128),
             (11056, 128), (4000, 1024)]


@pytest.mark.parametrize("m,n", K3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_on_card(dev, m, n, dtype):
    x, y, w, wb = _logistic_inputs(dev, m, n, dtype)
    before = tk.fused_logistic_value_grad.launches
    f, gw, gb = tk.fused_logistic_value_grad(x, y, w, wb)
    torch.cuda.synchronize()
    assert tk.fused_logistic_value_grad.launches == before + 1
    assert f.dtype == gw.dtype == gb.dtype == torch.float32 and gw.shape == (n,)
    f_p, gw_p, gb_p = tk.logistic_value_grad_plain(x, y, w, wb)  # bf16: the same values upcast
    # f32 FMAs in another summation order than cuBLAS, and expf/log1pf against
    # PyTorch's: ~sqrt(n) * 6e-8 in the sums
    assert abs(float(f - f_p)) <= 1e-5 * abs(float(f_p))
    g, g_p = torch.cat([gw, gb[None]]), torch.cat([gw_p, gb_p[None]])
    assert float((g - g_p).abs().max()) <= 1e-5 * float(g_p.abs().max())


def test_k3_is_repeatable_bit_for_bit(dev):
    x, y, w, wb = _logistic_inputs(dev, 3000, 777, torch.float32, seed=1)
    runs = [tk.fused_logistic_value_grad(x, y, w, wb) for _ in range(2)]
    assert all(torch.equal(u, v) for u, v in zip(*runs))


def test_k3_unaligned_view_takes_scalar_loads(dev):
    x, y, w, wb = _logistic_inputs(dev, 64, 128, torch.float32, seed=2)
    w_buf = torch.cat([torch.zeros(1, device=dev), w])
    f, gw, gb = tk.fused_logistic_value_grad(x, y, w_buf[1:], wb)
    f_p, gw_p, gb_p = tk.logistic_value_grad_plain(x, y, w, wb)
    assert abs(float(f - f_p)) <= 1e-5 * abs(float(f_p))
    assert float((gw - gw_p).abs().max()) <= 1e-5 * float(gw_p.abs().max())


def test_k3_rejects_what_it_does_not_take(dev):
    x, y, w, wb = _logistic_inputs(dev, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.fused_logistic_value_grad(x.double(), y, w, wb)  # f64 stays on the CPU
    with pytest.raises(TypeError, match="float32 y, w and w_bias"):
        tk.fused_logistic_value_grad(x, y.double(), w, wb)
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_logistic_value_grad(x.t().contiguous().t(), y, w, wb)
    with pytest.raises(ValueError, match="different devices"):
        tk.fused_logistic_value_grad(x, y.cpu(), w, wb)


@pytest.mark.parametrize("m,n", [(8128, 128), (8124, 112)])  # mushrooms padded, and as loaded
def test_logistic_loss_fused_launches_k3_per_oracle_call(dev, m, n):
    """LogisticLoss(fused=True), tile-aligned X or not: one K3 launch for
    each oracle call of the engine (the warm-up and one an iteration)."""
    from adaprox_tpu_torch import AdaPGMRule, L1Norm, LogisticLoss, adaptive_proxgrad

    x, y, _, _ = _logistic_inputs(dev, m, n, torch.float32, seed=3)
    before = tk.fused_logistic_value_grad.launches
    res = adaptive_proxgrad(torch.zeros(n + 1, device=dev), f=LogisticLoss(x, y, fused=True),
                            g=L1Norm(0.01), rule=AdaPGMRule(gamma=1.0), tol=0.0, maxit=20)
    torch.cuda.synchronize()
    assert tk.fused_logistic_value_grad.launches - before == res.counters.f_evals == 21


# -- K2 and K2c with the logistic objective -------------------------------------------------


def logreg_problem(dev, m_true, n_feat, m_pad, n_pad, seed=0):
    """[X 1] zero-padded to (m_pad, n_pad), labels padded with 0, gamma0 =
    1/Lf with the reference's Frobenius Lf, lam 0.01."""
    x, y, _, _ = _logistic_inputs(dev, m_true, n_feat, torch.float32, seed)
    a = torch.zeros(m_pad, n_pad, device=dev)
    a[:m_true, :n_feat] = x
    a[:m_true, n_feat] = 1.0
    b = torch.zeros(m_pad, device=dev)
    b[:m_true] = y
    x1 = a[:m_true, :n_feat + 1].double()
    gam = 4 * m_true / float(torch.linalg.matrix_norm(x1.t() @ x1))
    return a, b, gam


# a5a's and mushrooms' [X 1] padded as the drivers pad it (m_true < m), and a
# ragged shape that takes the scalar loads
LOGREG_SHAPES = [(6414, 123, 6416, 128), (8124, 112, 8128, 128), (997, 300, 1000, 301)]


@pytest.mark.parametrize("body", ["adapgm", "mm", "fixed", "momentum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LOGREG_SHAPES)
def test_k2_logreg_matches_plain_on_card(dev, shape, dtype, body):
    """Held like K2's least-squares rows: the fixed step and the momentum
    body over 30 iterations at 1e-5, the adaptive rules over 3 at 1e-3."""
    m_true, n_feat, m, n = shape
    a, b, gam = logreg_problem(dev, m_true, n_feat, m, n)
    a = a.to(dtype)
    x0 = torch.zeros(n, device=dev)
    kw = dict(rule_kind="fixed" if body == "momentum" else body, momentum=body == "momentum",
              record=True, m_true=float(m_true))
    maxit, rtol = (30, MOMENTUM_RTOL) if body in ("fixed", "momentum") else (3, 1e-3)
    before = tr.resident_adapgm.launches
    got = tr.resident_logreg_l1(a, b, x0, gam, 0.01, 0.0, maxit, **kw)
    torch.cuda.synchronize()
    assert tr.resident_adapgm.launches == before + 1
    want = tr.resident_adapgm_plain(a, b, x0, gam, 0.0, maxit, prox_kind="l1", p1=0.01,
                                    obj_kind="logreg", **kw)
    assert int(got[1]) == int(want[1]) == maxit
    _rows_close(got, want, maxit, rtol)
    assert float((got[0] - want[0]).abs().max()) <= rtol * float(want[0].abs().max())
    assert not bool(got[0][n_feat + 1:].any())  # the padded columns stay exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2c_logreg_rows_equal_single_k2_launches(dev, dtype):
    """The sparse_logreg driver's five rows (the ground truth at tol/10 with
    cap 10 x maxit, Nesterov at maxit/2) in one sweep: each row is its
    single K2 launch, bit for bit."""
    from adaprox_tpu_torch.experiments.sparse_logreg import rule_specs

    a, b, gam = logreg_problem(dev, 8124, 112, 8128, 128, seed=4)
    a = a.to(dtype)
    x0 = torch.zeros(128, device=dev)
    specs = rule_specs(gam, 1e-5, 40)
    kw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=8124.0)
    xs, its, res, conv, hists = tr.resident_rule_sweep(a, b, x0, tr.rule_rows(specs), 1e-5, 400,
                                                       **kw)
    torch.cuda.synchronize()
    for j, (g0, rule, mom, tol, cap) in enumerate(specs):
        one = tr.resident_adapgm(a, b, x0, g0, tol, cap, rule_kind=rule, momentum=mom,
                                 record=True, **kw)
        for k, got in enumerate((xs[j], its[j], res[j], conv[j])):
            assert torch.equal(got, one[k]), (j, k)
        for k in range(3):
            assert torch.equal(hists[k][j][:cap], one[4 + k]), (j, k)


def test_sparse_logreg_resident_is_one_k2c_launch_per_dataset(dev, tmp_path, capsys):
    """Two datasets (their synthetic stand-ins), each one K2c, one K4b and one
    aGRAAL launch; no K1, K2, K3 or K4 launch."""
    from adaprox_tpu_torch.experiments import sparse_logreg
    from adaprox_tpu_torch.utils.logging import read_jsonl

    counters = (tk.fused_ls_value_grad, tk.fused_logistic_value_grad, tr.resident_adapgm,
                tr.resident_rule_sweep, trb.resident_backtracking, trb.resident_bt_sweep,
                trb.resident_agraal)
    before = [c.launches for c in counters]
    sparse_logreg.main(["--resident", "--datasets", "heart_scale,a5a", "--maxit", "50",
                        "--device", "cuda", "--outdir", str(tmp_path), "--no-plot"])
    torch.cuda.synchronize()
    assert "falling back" not in capsys.readouterr().out
    assert [c.launches - k for c, k in zip(counters, before)] == [0, 0, 0, 2, 0, 2, 2]
    for name in ("heart_scale", "a5a"):
        rows = read_jsonl(tmp_path / f"{name}.jsonl")
        assert rows[-2]["fast_path"] == "resident" and rows[-1] == {"data_source": "synthetic"}
        methods = {r.get("method") for r in rows if "it" in r}
        assert methods == {None, "PGM (1/Lf)", "Nesterov (fixed)", "AdaPGM (MM)",
                           "AdaPGM (Ours)", "PGM (backtracking)-(xi=1.0)",
                           "PGM (backtracking)-(xi=1.5)", "PGM (backtracking)-(xi=2.0)",
                           "Nesterov (backtracking)", "aGRAAL"}


# -- K2 and K2c with the cubic objective ---------------------------------------------------


def cubic_problem(dev, n_true, n, c, seed=0):
    """The cubic model of a logistic Hessian at 0 (the cubic driver's H and
    q: sparse N(0, 1) features, 30% nonzero, labels from a noisy linear
    model), zero-padded from n_true to n, with c; gamma0 = 1/(||H||_2 + c),
    a stable step near the solution."""
    x, y, _, _ = _logistic_inputs(dev, 2 * n_true, n_true - 1, torch.float32, seed)
    m = x.shape[0]
    x1 = torch.cat([x, torch.ones(m, 1, device=dev)], 1)
    # the Hessian and gradient of the mean logistic loss at w = 0 (probs = 1/2)
    h = torch.zeros(n, n, device=dev)
    h[:n_true, :n_true] = 0.25 / m * (x1.t() @ x1)
    q = torch.zeros(n, device=dev)
    q[:n_true] = x1.t() @ (0.5 - y) / m
    gam = 1.0 / (float(torch.linalg.matrix_norm(h.double(), 2)) + c)
    return h, q, gam


def worst_problem(dev, k=100, lip=100.0):
    """The worst case on k = n coordinates as the c = 0 cubic model, padded to 128."""
    from adaprox_tpu_torch.experiments.nesterov_worst_case import worst_case_model

    h, q = worst_case_model(k, k, lip, dev, torch.float32)
    return h, q, 1.0 / lip


# mushrooms' model (113 padded to 128), a ragged 301 (scalar loads) and 2048
CUBIC_SHAPES = [(113, 128), (301, 301), (2048, 2048)]


@pytest.mark.parametrize("body", ["adapgm", "mm", "fixed", "momentum"])
@pytest.mark.parametrize("c", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUBIC_SHAPES)
def test_k2_cubic_matches_plain_on_card(dev, shape, dtype, c, body):
    """Held like K2's least-squares rows: the fixed step and the momentum
    body over 30 iterations at 1e-5, the adaptive rules over 3 at 1e-3; the
    padded coordinates stay exactly 0."""
    n_true, n = shape
    h, q, gam = cubic_problem(dev, n_true, n, c)
    h = h.to(dtype)
    x0 = torch.zeros(n, device=dev)
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c, record=True,
              rule_kind="fixed" if body == "momentum" else body, momentum=body == "momentum")
    maxit, rtol = (30, MOMENTUM_RTOL) if body in ("fixed", "momentum") else (3, 1e-3)
    before = tr.resident_adapgm.launches
    got = tr.resident_adapgm(h, q, x0, gam, 0.0, maxit, **kw)
    torch.cuda.synchronize()
    assert tr.resident_adapgm.launches == before + 1
    want = tr.resident_adapgm_plain(h, q, x0, gam, 0.0, maxit, **kw)
    assert int(got[1]) == int(want[1]) == maxit
    _rows_close(got, want, maxit, rtol)
    assert float((got[0] - want[0]).abs().max()) <= rtol * float(want[0].abs().max())
    assert not bool(got[0][n_true:].any())
    # without record mode: the same solve, the same bits
    plain = tr.resident_adapgm(h, q, x0, gam, 0.0, maxit, **dict(kw, record=False))
    assert all(torch.equal(u, w) for u, w in zip(plain, got[:4]))


def test_k2_cubic_worst_case_momentum_record_row(dev):
    """The worst case (c = 0) through the momentum body in record mode: the
    objective at x_new from P1's partials, over 120 iterations."""
    h, q, gam = worst_problem(dev)
    x0 = torch.zeros(128, device=dev)
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=0.0, momentum=True, record=True)
    got = tr.resident_adapgm(h, q, x0, gam, 0.0, 120, **kw)
    want = tr.resident_adapgm_plain(h, q, x0, gam, 0.0, 120, **kw)
    assert int(got[1]) == int(want[1]) == 120 and torch.equal(got[4], want[4])
    _rows_close(got, want, 120, MOMENTUM_RTOL)
    assert not bool(got[0][100:].any())
    # the recorded objective is the worst case's f at the returned iterate
    from adaprox_tpu_torch.convert import worst_from_numpy

    f = worst_from_numpy(100, 100.0, 128, device=dev, dtype=torch.float32)
    assert abs(float(got[6][-1] - f.value(got[0]))) <= 1e-5 * abs(float(got[6][-1]))


@pytest.mark.parametrize("case", ["cubic driver", "worst case"])
def test_k2c_cubic_rows_equal_single_k2_launches(dev, case):
    """The drivers' rows in one sweep: each row is its single K2 launch, bit
    for bit; two launches give the same bits."""
    if case == "cubic driver":
        from adaprox_tpu_torch.experiments.cubic_sparse_logreg import rule_specs

        h, q, gam = cubic_problem(dev, 113, 128, 1.0, seed=4)
        specs, c, maxit = rule_specs(gam, 1e-7, 60), 1.0, 600
    else:
        h, q, gam = worst_problem(dev)
        specs = [(gam, rule, mom, 1e-6, 400) for rule, mom in
                 (("fixed", False), ("fixed", True), ("mm", False), ("adapgm", False))]
        c, maxit = 0.0, 400
    x0 = torch.zeros(128, device=dev)
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c)
    before = tr.resident_rule_sweep.launches
    runs = [tr.resident_rule_sweep(h, q, x0, tr.rule_rows(specs), 0.0, maxit, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tr.resident_rule_sweep.launches == before + 2
    assert all(torch.equal(u, w) for u, w in zip(runs[0][:4], runs[1][:4]))
    assert all(torch.equal(u, w) for u, w in zip(runs[0][4], runs[1][4]))
    xs, its, res, conv, hists = runs[0]
    for j, (g0, rule, mom, tol, cap) in enumerate(specs):
        one = tr.resident_adapgm(h, q, x0, g0, tol, cap, rule_kind=rule, momentum=mom,
                                 record=True, **kw)
        for k, got in enumerate((xs[j], its[j], res[j], conv[j])):
            assert torch.equal(got, one[k]), (j, k)
        for k in range(3):
            assert torch.equal(hists[k][j][:cap], one[4 + k]), (j, k)


def test_k2c_cubic_matches_plain_on_card(dev):
    h, q, gam = cubic_problem(dev, 301, 301, 1.0, seed=5)
    x0 = torch.zeros(301, device=dev)
    specs = [(gam, "fixed", False), (gam, "fixed", True), (gam, "mm", False),
             (gam, "adapgm", False)]
    rows = tr.rule_rows(specs, tol=0.0, maxit=30)
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)
    got = tr.resident_rule_sweep(h, q, x0, rows, 0.0, 30, **kw)
    want = tr.resident_rule_sweep_plain(h, q, x0, rows, 30, **kw)
    for j, (_, rule, mom) in enumerate(specs):
        horizon, rtol = (30, MOMENTUM_RTOL) if rule == "fixed" else (3, 1e-3)
        row = lambda out: (out[0][j], out[1][j], out[2][j], out[3][j], *(h_[j] for h_ in out[4]))
        _rows_close(row(got), row(want), horizon, rtol)


def test_cubic_refuses_a_non_square_h_on_card(dev):
    a, b, x = _inputs(dev, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="square H"):
        tr.resident_adapgm(a, b, x, 0.1, 0.0, 3, obj_kind="cubic", cube_c=1.0)
    with pytest.raises(ValueError, match="square H"):
        tr.resident_rule_sweep(a, b, x, tr.rule_rows([(0.1, "fixed", False)], 0.0, 3), 0.0, 3,
                               obj_kind="cubic", cube_c=1.0)


def test_cubic_drivers_resident_are_one_k2c_launch(dev, tmp_path):
    """Each driver's --resident run is one K2c and one K4b launch, and
    cubic_sparse_logreg's one aGRAAL launch more (the worst case's menu has no
    aGRAAL row), and nothing else."""
    from adaprox_tpu_torch.experiments import cubic_sparse_logreg, nesterov_worst_case
    from adaprox_tpu_torch.utils.logging import read_jsonl

    counters = (tk.fused_ls_value_grad, tk.fused_logistic_value_grad, tr.resident_adapgm,
                tr.resident_rule_sweep, trb.resident_backtracking, trb.resident_bt_sweep,
                trb.resident_agraal)
    before = [c.launches for c in counters]
    cubic_sparse_logreg.main(["--resident", "--datasets", "heart_scale", "--device", "cuda",
                              "--outdir", str(tmp_path), "--no-plot"])
    nesterov_worst_case.main(["--resident", "--maxit", "500", "--device", "cuda", "--outdir",
                              str(tmp_path), "--no-plot"])
    torch.cuda.synchronize()
    assert [c.launches - k for c, k in zip(counters, before)] == [0, 0, 0, 2, 0, 2, 1]
    rows = read_jsonl(tmp_path / "heart_scale.jsonl")
    assert rows[-2]["fast_path"] == "resident"
    assert {r.get("method") for r in rows if "it" in r} == {
        None, "AdaPGM (MM)", "AdaPGM (Ours)", "PGM (backtracking)-(xi=1.0)",
        "PGM (backtracking)-(xi=1.5)", "PGM (backtracking)-(xi=2.0)", "Nesterov (backtracking)",
        "aGRAAL"}
    rows = read_jsonl(tmp_path / "nesterov_worst_case.jsonl")
    assert rows[-1]["fast_path"] == "resident"
    assert [r.get("method") for r in rows if "it" in r][0] is None


# -- K4 and K4b, the backtracking kernels ----------------------------------------------------

# PG with xi 1, 1.5 and 2, and Nesterov: (xi, nesterov)
BT_METHODS = [(1.0, False), (1.5, False), (2.0, False), (1.0, True)]
# Trial counts and step sizes are held equal, and norm_res and the objective to
# 1e-3 of their row's largest value, over horizons inside those chip_smoke.py
# calibrates on the CPU (plain f32 against f64; the trial counts first differed
# at iteration 7 for xi 2, 10 for xi 1.5, 27 for Nesterov and 64 for xi 1 on the
# shortest of its problems): after that a knife-edge trial may go either way. The
# problems below start from 10x the stable step and converge faster: on an H100
# the card and the plain version first took other trial counts at iteration 40
# (least squares, bf16 storage, xi 1) and 14 (the logistic and cubic cases, xi 1).
BT_HORIZON = {1.0: 10, 1.5: 5, 2.0: 4, "nesterov": 12}
BT_RTOL = 1e-3


def bt_case(dev, obj, dtype):
    """(a, b, gamma0, kwargs) of a K4 case: least squares on 1000x300 (l1,
    gamma0 10/||A||^2, so the trials shrink), the logistic loss on a sparse
    1000x128 (l1 0.01, 4 zero-padded rows) or mushrooms-sized cubic model
    (113 padded to 128, c 1, zero prox)."""
    if obj == "ls":
        a, b, _ = _inputs(dev, 1000, 300, torch.float32, seed=7)
        gam = 10.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
        return a.to(dtype), b, gam, dict(prox_kind="l1", p1=0.1)
    if obj == "logreg":
        x, y, _, _ = _logistic_inputs(dev, 996, 127, torch.float32, seed=7)
        a = torch.zeros(1000, 128, device=dev)
        a[:996, :127], a[:996, 127] = x, 1.0
        b = torch.zeros(1000, device=dev)
        b[:996] = y
        gam = 10.0 * 4 * 996 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
        return a.to(dtype), b, gam, dict(prox_kind="l1", p1=0.01, obj_kind="logreg",
                                         m_true=996.0)
    h, q, gam = cubic_problem(dev, 113, 128, 1.0, seed=7)
    return h.to(dtype), q, 10.0 * gam, dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)


def _bt_close(got, want, horizon):
    """Trial counts and step sizes equal, norm_res and the objective within
    BT_RTOL of the plain row's largest value, over the horizon."""
    assert torch.equal(got[8][:horizon], want[8][:horizon]), (got[8][:horizon], want[8][:horizon])
    assert torch.equal(got[5][:horizon], want[5][:horizon])
    for k in (6, 7):
        u, w = got[k][:horizon], want[k][:horizon]
        assert float((u - w).abs().max()) <= BT_RTOL * float(w.abs().max()), k


@pytest.mark.parametrize("xi,nesterov", BT_METHODS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_k4_matches_plain_on_card(dev, obj, dtype, xi, nesterov):
    a, b, gam, kw = bt_case(dev, obj, dtype)
    horizon = BT_HORIZON["nesterov" if nesterov else xi]
    x0 = torch.zeros(a.shape[1], device=dev)
    before = trb.resident_backtracking.launches
    got = trb.resident_backtracking(a, b, x0, gam, -1.0, horizon, xi=xi, nesterov=nesterov,
                                    record=True, **kw)
    torch.cuda.synchronize()
    assert trb.resident_backtracking.launches == before + 1
    want = trb.resident_backtracking_plain(a, b, x0, gam, -1.0, horizon, xi=xi,
                                           nesterov=nesterov, record=True, **kw)
    assert got[0].dtype == torch.float32 and all(h.shape == (horizon,) for h in got[5:])
    assert int(got[1]) == int(want[1]) == horizon and not bool(got[4]) and not bool(want[4])
    _bt_close(got, want, horizon)
    assert float((got[0] - want[0]).abs().max()) <= BT_RTOL * float(want[0].abs().max())
    if obj == "cubic":
        assert not bool(got[0][113:].any())
    # without record mode: the same solve, the same bits
    plain = trb.resident_backtracking(a, b, x0, gam, -1.0, horizon, xi=xi, nesterov=nesterov,
                                      **kw)
    assert all(torch.equal(u, w) for u, w in zip(plain, got[:5]))


@pytest.mark.parametrize("xi,nesterov", BT_METHODS)
def test_k4_exact_bregman_matches_plain_on_card(dev, xi, nesterov):
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    horizon = BT_HORIZON["nesterov" if nesterov else xi]
    x0 = torch.zeros(300, device=dev)
    kw.update(xi=xi, nesterov=nesterov, record=True, exact_bregman=True)
    got = trb.resident_backtracking(a, b, x0, gam, -1.0, horizon, **kw)
    want = trb.resident_backtracking_plain(a, b, x0, gam, -1.0, horizon, **kw)
    _bt_close(got, want, horizon)


@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_k4b_rows_equal_single_k4_launches(dev, obj):
    """The drivers' four backtracking rows in one sweep, solved to tol 1e-6:
    each row is its single K4 launch, bit for bit; two launches give the same
    bits."""
    from adaprox_tpu_torch.experiments.common import BT_ROWS, bt_sweep_rows

    a, b, gam, kw = bt_case(dev, obj, torch.float32)
    x0 = torch.zeros(a.shape[1], device=dev)
    rows = bt_sweep_rows(BT_ROWS, gam)
    before = trb.resident_bt_sweep.launches
    runs = [trb.resident_bt_sweep(a, b, x0, rows, 1e-6, 400, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert trb.resident_bt_sweep.launches == before + 2
    assert all(torch.equal(u, w) for u, w in zip(runs[0][:5], runs[1][:5]))
    assert all(torch.equal(u, w) for u, w in zip(runs[0][5], runs[1][5]))
    for j, (g0, xi, flag) in enumerate(rows):
        one = trb.resident_backtracking(a, b, x0, g0, 1e-6, 400, xi=xi, nesterov=flag > 0,
                                        record=True, **kw)
        for k in range(5):
            assert torch.equal(runs[0][k][j], one[k]), (j, k)
        for k in range(4):
            assert torch.equal(runs[0][5][k][j], one[5 + k]), (j, k)


def test_k4_is_repeatable_and_zero_iterations_return_x0(dev):
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    x0 = torch.randn(300, device=dev)
    runs = [trb.resident_backtracking(a, b, x0, gam, 1e-5, 2000, xi=1.5, record=True, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(*runs))
    got = trb.resident_backtracking(a, b, x0, gam, 0.0, 0, record=True, **kw)
    assert int(got[1]) == 0 and torch.equal(got[0], x0) and float(got[2]) == float("inf")
    assert not bool(got[3]) and not bool(got[4]) and all(h.shape == (0,) for h in got[5:])


def test_k4_trial_cap_is_latched_on_card(dev):
    """shrink = 1 and a step far past stable: each backtrack takes its 101
    evaluations and fails; ls_failed latches it, as the plain version does."""
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    x0 = torch.zeros(300, device=dev)
    got = trb.resident_backtracking(a, b, x0, 1e3 * gam, 0.0, 3, shrink=1.0, record=True, **kw)
    want = trb.resident_backtracking_plain(a, b, x0, 1e3 * gam, 0.0, 3, shrink=1.0, record=True,
                                           **kw)
    assert bool(got[4]) and bool(want[4]) and got[8].tolist() == want[8].tolist() == [101.0] * 3


def test_k4_exact_bregman_large_f_on_card(dev):
    """tests/test_kernels.py's large-|f| f32 lasso (b = A xs 1e3 + noise): the
    raw sufficient-descent test carries eps |f| noise. PG with the
    exact-Bregman test converges, in at least 10x fewer iterations or where the
    raw test does not converge in 20000. Nesterov reaches tol 1e-4 with neither
    test in f32 (norm_res stalls at the instance's f32 noise floor; see
    chip_smoke.py, case x), so there the exact test must leave F at least 10x
    closer to F* after 120 iterations (an f64 run of the plain version gives
    F*)."""
    import numpy as np

    rng = np.random.default_rng(0)
    m, n = 1536, 384
    a_np = rng.standard_normal((m, n)) / np.sqrt(n)
    xs = rng.standard_normal(n) * (rng.random(n) < 0.1)
    b_np = a_np @ xs * 1e3 + rng.standard_normal(m)
    a = torch.as_tensor(a_np, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    gam = 1.0 / float(np.linalg.norm(a_np, 2) ** 2)
    raw, exact = (trb.resident_backtracking(a, b, torch.zeros(n, device=dev), gam, 1e-4, 20000,
                                            p1=1.0, exact_bregman=eb) for eb in (False, True))
    assert bool(exact[3])
    assert int(exact[1]) * 10 <= int(raw[1]) or not bool(raw[3]), (int(exact[1]), int(raw[1]))
    a64, b64 = a.double(), torch.as_tensor(b_np, device=dev)
    star = trb.resident_backtracking_plain(a64, b64, torch.zeros(n, dtype=torch.float64,
                                                                 device=dev), gam, 1e-10, 3000,
                                           nesterov=True, p1=1.0)

    def objective(x):
        r = a64 @ x.double() - b64
        return float(0.5 * r @ r + x.double().abs().sum())

    gaps = [objective(trb.resident_backtracking(a, b, torch.zeros(n, device=dev), gam, 1e-4, 120,
                                                p1=1.0, nesterov=True, exact_bregman=eb)[0])
            - objective(star[0]) for eb in (False, True)]
    assert 10 * abs(gaps[1]) <= abs(gaps[0]), gaps


def test_k4_counts_one_launch_a_solve(dev):
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    x0 = torch.zeros(300, device=dev)
    before = (trb.resident_backtracking.launches, trb.resident_bt_sweep.launches)
    trb.resident_backtracking(a, b, x0, gam, 0.0, 5, **kw)
    trb.resident_backtracking(a, b, x0, gam, 0.0, 5, nesterov=True, record=True, **kw)
    trb.resident_bt_sweep(a, b, x0, [[gam, 1.0, 0.0]], 0.0, 5, **kw)
    assert (trb.resident_backtracking.launches, trb.resident_bt_sweep.launches) == (
        before[0] + 2, before[1] + 1)


def test_k4_rejects_what_it_does_not_take(dev):
    a, b, x = _inputs(dev, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trb.resident_backtracking(a.double(), b, x, 0.1, 0.0, 3)
    with pytest.raises(TypeError, match="float32 b and x0"):
        trb.resident_backtracking(a, b.double(), x, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        trb.resident_backtracking(a.t().contiguous().t(), b, x, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="square H"):
        trb.resident_backtracking(a, b, x, 0.1, 0.0, 3, obj_kind="cubic", cube_c=1.0)
    for rows in ([[0.1, 1.0]], [[0.1, 1.0, 2.0]], torch.zeros(0, 3)):
        with pytest.raises(ValueError, match="rows must be|0 or 1"):
            trb.resident_bt_sweep(a, b, x, rows, 0.0, 3)


def _k4b_rows_are_k4(a, b, x0, rows, tol, maxit, **kw):
    """One K4b launch over ``rows``: each row equals its own K4 launch bit for bit (x, the
    stats and the histories), and the grid syncs the kernel counted are ``k4b_syncs`` of its
    records over ``k4b_plan``'s groups. Returns the sweep's output."""
    out = trb.resident_bt_sweep(a, b, x0, rows, tol, maxit, **kw)
    syncs = int(trb.resident_bt_sweep.last_syncs)
    plan = trb.k4b_plan(len(rows), *a.shape, a.element_size(), tk._sm_count(a.device.index))
    nests = [float(r[2]) > 0 for r in rows]
    cubic = kw.get("obj_kind") == "cubic"
    assert syncs == trb.k4b_syncs(plan["groups"], out[1].tolist(), out[5][3].tolist(), nests,
                                  cubic)
    for j, (g0, xi, flag) in enumerate(rows):
        one = trb.resident_backtracking(a, b, x0, g0, tol, maxit, xi=xi, nesterov=flag > 0,
                                        record=True, **kw)
        for k in range(5):
            assert torch.equal(_bits(out[k][j]), _bits(one[k])), (j, k)
        for k in range(4):
            assert torch.equal(_bits(out[5][k][j]), _bits(one[5 + k])), (j, k)
        # K4's own count: its syncs from its records
        assert int(trb.resident_backtracking.last_syncs) == trb.k4b_syncs(
            [[0]], [int(one[1])], [one[8].tolist()], [flag > 0], cubic)
    return out


def _k4b_table(gam, count, seed=0):
    """``count`` rows mixing PG xi 1 / 1.5 / 2 and Nesterov from gamma0 1x to 12x the stable
    step (the larger ones shrink), permuted with ``seed``: each row at some place of some
    group, beside other rows."""
    kinds = [(1.0, 0.0), (1.5, 0.0), (2.0, 0.0), (1.0, 1.0)]
    rows = [[gam * (1 + (j % 12)), *kinds[(j + j // 4) % 4]] for j in range(count)]
    order = torch.randperm(count, generator=torch.Generator().manual_seed(seed)).tolist()
    return [rows[i] for i in order]


@pytest.mark.parametrize("count", [1, 4, 8, 9, 17])
def test_k4b_rows_are_k4_at_every_place_in_a_group(dev, count):
    """Tables of 1, 4, 8, 9 and 17 rows (groups of 8 in turn), permuted: every row is its own
    K4 launch bit for bit, whatever its group, its place there or its neighbours; the table
    reversed gives the rows reversed."""
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    x0 = torch.zeros(a.shape[1], device=dev)
    rows = _k4b_table(gam, count, seed=count)
    out = _k4b_rows_are_k4(a, b, x0, rows, 1e-6, 300, **kw)
    back = trb.resident_bt_sweep(a, b, x0, rows[::-1], 1e-6, 300, **kw)
    for k in range(5):
        assert torch.equal(_bits(back[k].flip(0)), _bits(out[k]))
    assert len(set(out[1].tolist())) > 1 or count == 1


@pytest.mark.parametrize("obj,dtype,exact", [
    ("ls", torch.float32, True), ("ls", torch.bfloat16, False), ("ls", torch.bfloat16, True),
    ("logreg", torch.float32, False), ("logreg", torch.bfloat16, False),
    ("cubic", torch.float32, False), ("cubic", torch.bfloat16, False)])
def test_k4b_rows_are_k4_across_storage_objectives_and_tests(dev, obj, dtype, exact):
    a, b, gam, kw = bt_case(dev, obj, dtype)
    x0 = torch.zeros(a.shape[1], device=dev)
    if exact:
        kw["exact_bregman"] = True
    _k4b_rows_are_k4(a, b, x0, _k4b_table(gam, 6, seed=1), 1e-6, 200, **kw)


def test_k4b_fly_route_rows_are_k4(dev):
    """Eight rows at 64x7040: the group's points (8 x 7040 f32) do not fit a CTA's shared
    memory, so each dot forms them as it goes; K4 alone stages its one row. Every row is its
    K4 launch bit for bit: the two routes give the same bits."""
    a, b, _ = _inputs(dev, 64, 7040, torch.float32, seed=5)
    sms = tk._sm_count(dev.index)
    assert trb.k4b_plan(8, 64, 7040, 4, sms)["route"] == "fly"
    assert trb.k4b_plan(1, 64, 7040, 4, sms)["route"] == "staged"
    gam = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    x0 = torch.zeros(7040, device=dev)
    _k4b_rows_are_k4(a, b, x0, _k4b_table(gam, 8, seed=2), 1e-6, 60, prox_kind="l1", p1=0.05)
    h, q, gam_c = cubic_problem(dev, 7000, 7040, 1.0, seed=2)
    _k4b_rows_are_k4(h, q, torch.zeros(7040, device=dev), _k4b_table(gam_c, 8, seed=3), 1e-6,
                     8, prox_kind="zero", obj_kind="cubic", cube_c=1.0)


def test_k4b_rows_are_k4_with_and_without_a_held(dev):
    """264x3072 f32: K4 holds each CTA's 16 rows of A (192 KB) in shared memory beside its
    one point, eight rows' points leave no room for them, so the sweep reads A from device
    memory every pass: every row is its K4 launch bit for bit, A held or not."""
    a, b, _ = _inputs(dev, 264, 3072, torch.float32, seed=8)
    sms = tk._sm_count(dev.index)
    assert trb.k4b_plan(1, 264, 3072, 4, sms)["a_held"]
    assert not trb.k4b_plan(8, 264, 3072, 4, sms)["a_held"]
    gam = 1.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    x0 = torch.zeros(3072, device=dev)
    _k4b_rows_are_k4(a, b, x0, _k4b_table(gam, 8, seed=4), 1e-6, 80, prox_kind="l1", p1=0.05)


def test_k4_fly_route_matches_plain(dev):
    """One row past a CTA's shared memory (16 x 57344 f32): K4 forms z in its dots; trial
    counts and step sizes equal to the plain version's over the horizon."""
    a, b, _ = _inputs(dev, 16, 57344, torch.float32, seed=6)
    assert trb.k4b_plan(1, 16, 57344, 4, tk._sm_count(dev.index))["route"] == "fly"
    gam = 10.0 / float(torch.linalg.matrix_norm(a.double(), 2) ** 2)
    x0 = torch.zeros(57344, device=dev)
    for xi, nest in ((1.5, False), (1.0, True)):
        horizon = BT_HORIZON["nesterov" if nest else xi]
        got = trb.resident_backtracking(a, b, x0, gam, -1.0, horizon, xi=xi, nesterov=nest,
                                        record=True, prox_kind="l1", p1=0.1)
        want = trb.resident_backtracking_plain(a, b, x0, gam, -1.0, horizon, xi=xi,
                                               nesterov=nest, record=True, prox_kind="l1",
                                               p1=0.1)
        _bt_close(got, want, horizon)


def test_k4b_edge_cases_rows_are_k4(dev):
    """The trial cap latched (shrink 1, 101 trials an iteration), maxit 0 and 1, tol inf (no
    row runs: x0 back, numit 0) and a NaN f(z) (a NaN in b: accepted, and the NaN residual
    stops), each a sweep whose rows are their K4 launches and agree with the plain version's
    decisions."""
    a, b, gam, kw = bt_case(dev, "ls", torch.float32)
    x0 = torch.randn(a.shape[1], device=dev)
    rows = _k4b_table(gam, 4)
    capped = _k4b_rows_are_k4(a, b, x0, [[1e3 * r[0], *r[1:]] for r in rows], 0.0, 3,
                              shrink=1.0, **kw)
    assert bool(capped[4].all()) and capped[5][3].eq(101).all()
    for tol, maxit in ((1e-6, 0), (1e-6, 1), (float("inf"), 20)):
        out = _k4b_rows_are_k4(a, b, x0, rows, tol, maxit, **kw)
        want = trb.resident_bt_sweep_plain(a, b, x0, rows, tol, maxit, **kw)
        assert out[1].tolist() == want[1].tolist() == [min(maxit, 0 if tol == float("inf")
                                                               else 1)] * 4
        if maxit == 0 or tol == float("inf"):
            assert all(torch.equal(out[0][j], x0) for j in range(4))
            assert int(trb.resident_bt_sweep.last_syncs) == 0
    b_nan = b.clone()
    b_nan[3] = float("nan")
    out = _k4b_rows_are_k4(a, b_nan, x0, rows, 1e-6, 50, **kw)
    want = trb.resident_bt_sweep_plain(a, b_nan, x0, rows, 1e-6, 50, **kw)
    assert out[1].tolist() == want[1].tolist() and out[5][3].tolist() == want[5][3].tolist()
    assert bool(out[2].isnan().all()) and bool(want[2].isnan().all())


# (count, m, n): the drivers' calls, the thresholds of the staged route, the sync floor
K4B_PLAN_CASES = [(4, 4000, 1024), (4, 6416, 128), (4, 8128, 128), (4, 11056, 128),
                  (4, 128, 128), (2, 128, 128), (1, 4096, 1024), (1, 8, 2176), (17, 300, 1000),
                  (8, 64, 7008), (8, 64, 7009), (1, 16, 56064), (1, 16, 56065), (9, 1, 1)]


@pytest.mark.parametrize("count,m,n", K4B_PLAN_CASES)
def test_k4b_plan_is_the_launchers(dev, count, m, n):
    for sms in (tk._sm_count(dev.index), 7):
        for itemsize in (4, 2):
            want = trb.k4b_plan(count, m, n, itemsize, sms)
            assert trb.k4b_card_plan(count, m, n, itemsize, sms) == {
                k: want[k] for k in trb.K4B_PLAN_KEYS}


# -- K4's aGRAAL core -------------------------------------------------------------------------

# The rows are held within 1e-3 of their largest value over 15 iterations: on the
# CPU the plain version in f32 first parted from f64 by more than 1e-5 at
# iteration 17 to 41, and by more than 1e-3 at 29 to 62 (chip_smoke.py,
# AGRAAL_HORIZON); the card sums in another order than the plain version.
AG_HORIZON = 15
AG_RTOL = 1e-3


def ag_case(dev, obj, dtype):
    """(a, b, x1, x0, n_true, gamma0, kwargs) of an aGRAAL case: K4's problems
    (bt_case) from x1 = 0, with gamma0 = 1/L and the companion point x1 + N(0, I)
    on the unpadded coordinates."""
    a, b, gam, kw = bt_case(dev, obj, dtype)
    n = a.shape[1]
    n_true = 113 if obj == "cubic" else n
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x1 = torch.zeros(n, device=dev)
    x0 = x1.clone()
    x0[:n_true] = torch.randn(n_true, generator=gen, device=dev)
    return a, b, x1, x0, n_true, gam / 10, kw


def _ag_close(got, want, horizon):
    for k in (4, 5, 6):
        u, w = got[k][:horizon], want[k][:horizon]
        assert float((u - w).abs().max()) <= AG_RTOL * float(w.abs().max()), k


@pytest.mark.parametrize("secant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_k4_agraal_matches_plain_on_card(dev, obj, dtype, secant):
    a, b, x1, x0, n_true, gam, kw = ag_case(dev, obj, dtype)
    g0 = 0.0 if secant else gam
    before = trb.resident_agraal.launches
    got = trb.resident_agraal(a, b, x1, x0, g0, -1.0, AG_HORIZON, record=True, **kw)
    torch.cuda.synchronize()
    assert trb.resident_agraal.launches == before + 1
    want = trb.resident_agraal_plain(a, b, x1, x0, g0, -1.0, AG_HORIZON, record=True, **kw)
    assert got[0].dtype == torch.float32 and all(h.shape == (AG_HORIZON,) for h in got[4:])
    assert int(got[1]) == int(want[1]) == AG_HORIZON and not bool(got[3])
    _ag_close(got, want, AG_HORIZON)
    assert float((got[0] - want[0]).abs().max()) <= AG_RTOL * float(want[0].abs().max())
    assert not bool(got[0][n_true:].any())
    # without record mode: the same solve, the same bits
    plain = trb.resident_agraal(a, b, x1, x0, g0, -1.0, AG_HORIZON, **kw)
    assert all(torch.equal(u, w) for u, w in zip(plain, got[:4]))


def test_k4_agraal_is_repeatable_and_zero_iterations_return_x1(dev):
    a, b, x1, x0, _, gam, kw = ag_case(dev, "ls", torch.float32)
    runs = [trb.resident_agraal(a, b, x1, x0, gam, 1e-4, 2000, record=True, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(*runs))
    x1 = torch.randn(300, device=dev)
    got = trb.resident_agraal(a, b, x1, x1 + 1.0, gam, 0.0, 0, record=True, **kw)
    assert int(got[1]) == 0 and torch.equal(got[0], x1) and float(got[2]) == float("inf")
    assert not bool(got[3]) and all(h.shape == (0,) for h in got[4:])


def test_k4_agraal_counts_one_launch_a_solve(dev):
    a, b, x1, x0, _, gam, kw = ag_case(dev, "ls", torch.float32)
    before = trb.resident_agraal.launches
    trb.resident_agraal(a, b, x1, x0, gam, 0.0, 5, **kw)
    trb.resident_agraal(a, b, x1, x0, 0.0, 0.0, 5, record=True, **kw)
    assert trb.resident_agraal.launches == before + 2


def test_k4_agraal_rejects_what_it_does_not_take(dev):
    a, b, x = _inputs(dev, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trb.resident_agraal(a.double(), b, x, x, 0.1, 0.0, 3)
    with pytest.raises(TypeError, match="float32 b and x0"):
        trb.resident_agraal(a, b.double(), x, x, 0.1, 0.0, 3)
    with pytest.raises(TypeError, match="float32 x0"):
        trb.resident_agraal(a, b, x, x.double(), 0.1, 0.0, 3)
    with pytest.raises(TypeError, match="float32 x0"):
        trb.resident_agraal(a, b, x, x.cpu(), 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        trb.resident_agraal(a.t().contiguous().t(), b, x, x, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="square H"):
        trb.resident_agraal(a, b, x, x, 0.1, 0.0, 3, obj_kind="cubic", cube_c=1.0)


# -- K6a, K6b and K6d, the dual-SVM primal-dual kernels -----------------------------------------

# Rows against the plain version within 1e-3 of their largest value over 25 iterations: on
# the CPU the plain version in f32 first parted from f64 by more than 1e-3 at iteration 39
# to 180 on the dual_svm driver's inputs (the step sizes; the residuals and Condat-Vu's rows
# not in 300; chip_smoke.py, PD_HORIZON); the card sums in another order than the plain
# version.
PD_HORIZON = 25
PD_RTOL = 1e-3
PD_TS = [0.05, 0.5, 2.0]


def pd_case(dev, dtype, factored, n=300, d=20, seed=3, n_pad=384):
    """(q, labels, n_true, norm_a) of a dual SVM of n points, zero-padded to n_pad: the Gram
    D_y X X' D_y (n_pad, n_pad), or B = D_y X padded to (n_pad, 128) when factored; q in
    ``dtype`` storage, the labels f32 (zero on the padded coordinates)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) / d**0.5
    y = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0)
    dyx = y[:, None] * x
    if factored:
        q = np.zeros((n_pad, 128))
        q[:n, :d] = dyx
    else:
        q = np.zeros((n_pad, n_pad))
        q[:n, :n] = dyx @ dyx.T
    lab = np.zeros(n_pad)
    lab[:n] = y
    return (torch.as_tensor(q, dtype=torch.float32, device=dev).to(dtype),
            torch.as_tensor(lab, dtype=torch.float32, device=dev), n, float(np.linalg.norm(y)))


def _pd_rows_close(got, want, horizon):
    for u, w in zip(got, want):
        u, w = u[..., :horizon], w[..., :horizon]
        assert float((u - w).abs().max()) <= PD_RTOL * float(w.abs().max())


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6b_matches_plain_on_card(dev, dtype, factored):
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, dtype, factored)
    kw = dict(n_true=n, record=True, factored=factored)
    before = tp.resident_adapdm_dsvm_sweep.launches
    got = tp.resident_adapdm_dsvm_sweep(q, lab, 0.5, PD_TS, na, -1.0, PD_HORIZON, **kw)
    torch.cuda.synchronize()
    assert tp.resident_adapdm_dsvm_sweep.launches == before + 1
    want = tp.resident_adapdm_dsvm_sweep_plain(q, lab, 0.5, PD_TS, na, -1.0, PD_HORIZON, **kw)
    assert got[0].dtype == torch.float32 and got[4].shape == (3, PD_HORIZON)
    assert got[1].tolist() == want[1].tolist() == [PD_HORIZON] * 3 and not bool(got[3].any())
    _pd_rows_close(got[4:], want[4:], PD_HORIZON)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())
    assert not bool(got[0][:, n:].any())  # the padded coordinates stay exactly 0


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6d_matches_plain_on_card(dev, dtype, factored):
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, dtype, factored)
    kw = dict(n_true=n, record=True, factored=factored)
    gamma, sigma = 0.05, 0.99 / na
    before = tp.resident_cv_dsvm.launches
    got = tp.resident_cv_dsvm(q, lab, 0.5, gamma, sigma, -1.0, 200, **kw)
    torch.cuda.synchronize()
    assert tp.resident_cv_dsvm.launches == before + 1
    want = tp.resident_cv_dsvm_plain(q, lab, 0.5, gamma, sigma, -1.0, 200, **kw)
    assert int(got[1]) == int(want[1]) == 200 and got[4][0].shape == (200,)
    # the fixed steps contract rounding: the whole run is held
    _pd_rows_close(got[4], want[4], 200)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())
    assert not bool(got[0][n:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6b_dense_rows_are_k6a_launches_bit_for_bit(dev, dtype):
    """A dense sweep row is its single K6a launch, bit for bit; a factored row its
    one-row sweep; two launches give the same bits."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, dtype, False)
    sweep = tp.resident_adapdm_dsvm_sweep(q, lab, 0.5, PD_TS, na, 1e-4, 3000, n_true=n,
                                          record=True)
    again = tp.resident_adapdm_dsvm_sweep(q, lab, 0.5, PD_TS, na, 1e-4, 3000, n_true=n,
                                          record=True)
    assert all(torch.equal(u, w) for u, w in zip(sweep, again))
    for j, t in enumerate(PD_TS):
        one = tp.resident_adapdm_dsvm(q, lab, 0.5, t, na, 1e-4, 3000, n_true=n)
        assert torch.equal(one[0], sweep[0][j]) and int(one[1]) == int(sweep[1][j])
        assert torch.equal(one[2], sweep[2][j]) and bool(one[3]) == bool(sweep[3][j])
    qf, labf, n, na = pd_case(dev, dtype, True)
    sweep = tp.resident_adapdm_dsvm_sweep(qf, labf, 0.5, PD_TS, na, 1e-4, 3000, n_true=n,
                                          factored=True)
    for j, t in enumerate(PD_TS):
        one = tp.resident_adapdm_dsvm_sweep(qf, labf, 0.5, [t], na, 1e-4, 3000, n_true=n,
                                            factored=True)
        assert all(torch.equal(u[0], w[j]) for u, w in zip(one, sweep))


@pytest.mark.parametrize("factored", [False, True])
def test_k6_converged_returns_the_checked_iterate(dev, factored):
    """Converged at iteration k, the solve returns the x of the check: the x after k - 1
    second halves, which a run capped at k - 1 iterations returns."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, torch.float32, factored)
    kw = dict(n_true=n, factored=factored)
    x, numit, nres, conv = tp.resident_adapdm_dsvm_sweep(q, lab, 0.5, [0.5], na, 1e-3, 5000, **kw)
    k = int(numit[0])
    assert bool(conv[0]) and float(nres[0]) <= 1e-3 and k > 1
    capped = tp.resident_adapdm_dsvm_sweep(q, lab, 0.5, [0.5], na, -1.0, k - 1, **kw)
    assert torch.equal(capped[0], x)
    x, numit, _, conv = tp.resident_cv_dsvm(q, lab, 0.5, 0.05, 0.99 / na, 1e-3, 20000, **kw)
    assert bool(conv)
    capped = tp.resident_cv_dsvm(q, lab, 0.5, 0.05, 0.99 / na, -1.0, int(numit) - 1, **kw)
    assert torch.equal(capped[0], x)


def test_k6_zero_iterations_and_refusals(dev):
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, torch.float32, False)
    x, numit, nres, conv = tp.resident_adapdm_dsvm(q, lab, 0.5, 1.0, na, 0.0, 0, n_true=n)
    want = tp.resident_adapdm_dsvm_plain(q, lab, 0.5, 1.0, na, 0.0, 0, n_true=n)
    assert int(numit) == 0 and float(nres) == float("inf") and not bool(conv)
    assert torch.equal(x, want[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tp.resident_adapdm_dsvm(q.double(), lab, 0.5, 1.0, na, 0.0, 3)
    with pytest.raises(TypeError, match="float32 labels"):
        tp.resident_cv_dsvm(q, lab.double(), 0.5, 0.1, 0.1, 0.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tp.resident_adapdm_dsvm_sweep(q.t().contiguous().t()[:, :384], lab, 0.5, [1.0], na, 0.0,
                                      3, factored=True)
    with pytest.raises(ValueError, match="must be positive"):
        tp.resident_adapdm_dsvm(q, lab, 0.5, 0.0, na, 0.0, 3)
    with pytest.raises(ValueError, match="square"):
        tp.resident_adapdm_dsvm(q[:, :128], lab, 0.5, 1.0, na, 0.0, 3)


# -- K6d's layout (ops/resident_pd.py::k6d_plan) and its one grid sync an iteration ---------

# The driver's shapes unpadded and the layouts past them, with each route's paths: (points,
# features, factored), three zero points after them (k6d_random). Ragged widths take scalar
# loads.
K6D_ROUTE_CASES = {
    "shared dense 270 (ragged)": (270, 13, False),
    "shared dense 1243 (ragged)": (1243, 21, False),
    "shared factored 8124 x 112 (ragged)": (8124, 112, True),
    "l2 dense 2203 (ragged, x staged)": (2203, 17, False),
    "l2 factored 30000 x 250 (ragged)": (30000, 250, True),
    "l2 factored 600 x 3500 (partials of B'x in device memory)": (600, 3500, True),
}
K6D_ROUTE_WANT = {"shared dense 270 (ragged)": ("shared", True, False),
                  "shared dense 1243 (ragged)": ("shared", True, False),
                  "shared factored 8124 x 112 (ragged)": ("shared", True, True),
                  "l2 dense 2203 (ragged, x staged)": ("l2", True, False),
                  "l2 factored 30000 x 250 (ragged)": ("l2", True, True),
                  "l2 factored 600 x 3500 (partials of B'x in device memory)": ("l2", True, False)}


def k6d_random(dev, n, d, factored, pad=3, seed=21):
    """(q, labels, n_true, gamma, sigma) of a random dual SVM of n points and d features with
    ``pad`` zero points after them: B = D_y X (factored) or the Gram B B', formed on the card
    (full f32); Condat-Vu's steps from its norms."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) / d**0.5
    y = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0)
    b = torch.zeros(n + pad, d, device=dev)
    b[:n] = torch.as_tensor(y[:, None] * x, dtype=torch.float32, device=dev)
    lab = torch.zeros(n + pad, device=dev)
    lab[:n] = torch.as_tensor(y, dtype=torch.float32, device=dev)
    lf = float(torch.linalg.matrix_norm(b.double(), ord=2)) ** 2
    na = float(np.linalg.norm(y))
    gamma = 1.0 / (lf + na)
    return (b if factored else b @ b.t()).contiguous(), lab, n, gamma, 0.9 / (gamma * na * na)


def _k6d_flat(out):
    return [out[0], out[1], out[2], out[3]] + (list(out[4]) if len(out) > 4 else [])


@pytest.mark.parametrize("sms", [132, 114, 64, 7])
def test_k6d_plan_is_the_launchers(dev, sms):
    """The Python plan and the C launcher's agree on every key, at the driver's shapes, the
    route cases, the thresholds and past them (the refusal too)."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    shapes = [(384, 0, False), (1280, 0, False), (8192, 128, True), (270, 0, False),
              (2112, 0, False), (2113, 0, False), (3397, 0, False), (3398, 0, False),
              (57856, 0, False), (57857, 0, False), (30000, 250, True), (600, 3500, True),
              (65536, 128, True), (100, tp.K6D_MAX_D, True), (100, tp.K6D_MAX_D + 1, True),
              (1, 1, True), (1, 0, False)]
    for n, d, factored in shapes:
        for itemsize in (4, 2):
            want = tp.k6d_plan(n, d, factored, itemsize, sms)
            assert tp.k6d_card_plan(n, d, factored, itemsize, sms) == want, (n, d, itemsize)


@pytest.mark.parametrize("case", list(K6D_ROUTE_CASES))
def test_k6d_routes_match_plain(dev, case):
    """Each route (rows held in shared memory or read from the L2; x staged; the warps'
    partials of B'x in shared or device memory) at ragged widths against the plain version
    over 200 iterations, the padded coordinates exactly 0, two launches the same bits."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    n, d, factored = K6D_ROUTE_CASES[case]
    q, lab, n_true, gamma, sigma = k6d_random(dev, n, d, factored)
    plan = tp.k6d_plan(q.shape[0], d if factored else 0, factored, 4,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    assert (plan["route"], plan["x_shared"], plan["acc_shared"]) == K6D_ROUTE_WANT[case]
    kw = dict(n_true=n_true, record=True, factored=factored)
    args = (q, lab, 0.5, gamma, sigma, -1.0, 200)
    got = tp.resident_cv_dsvm(*args, **kw)
    again = tp.resident_cv_dsvm(*args, **kw)
    want = tp.resident_cv_dsvm_plain(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(_k6d_flat(got), _k6d_flat(again)))
    assert int(got[1]) == int(want[1]) == 200
    _pd_rows_close(got[4], want[4], 200)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())
    assert not bool(got[0][n_true:].any())


def test_k6d_reads_x_from_device_memory_past_shared_memory(dev):
    """Dense past 57856 points x no longer fits a CTA's shared memory and the row pass reads
    it from device memory: a 57863^2 Gram (13.4 GB) against the plain version over 30
    iterations."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n_true, gamma, sigma = k6d_random(dev, 57860, 8, False)
    plan = tp.k6d_plan(q.shape[0], 0, False, 4,
                       torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan["route"] == "l2" and not plan["x_shared"] and plan["smem_bytes"] == 0
    kw = dict(n_true=n_true, record=True)
    got = tp.resident_cv_dsvm(q, lab, 0.5, gamma, sigma, -1.0, 30, **kw)
    want = tp.resident_cv_dsvm_plain(q, lab, 0.5, gamma, sigma, -1.0, 30, **kw)
    assert int(got[1]) == int(want[1]) == 30
    _pd_rows_close(got[4], want[4], 30)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("maxit", [0, 1, 2])
def test_k6d_counts_the_first_iterations_as_plain(dev, maxit, factored):
    """The stop decision waits for the next pass's sync: at maxit 0, 1 and 2 the solve counts,
    records and returns what the plain version does (maxit 0: x_0 itself, bit for bit)."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, torch.float32, factored)
    kw = dict(n_true=n, record=True, factored=factored)
    args = (q, lab, 0.5, 0.05, 0.99 / na, -1.0, maxit)
    got = tp.resident_cv_dsvm(*args, **kw)
    want = tp.resident_cv_dsvm_plain(*args, **kw)
    assert int(got[1]) == int(want[1]) == maxit and not bool(got[3])
    assert got[4][0].shape == got[4][1].shape == (maxit,)
    if maxit == 0:
        assert float(got[2]) == float("inf") and torch.equal(got[0], want[0])
    else:
        _pd_rows_close(got[4], want[4], maxit)
        assert float(got[2]) == float(got[4][0][-1])
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())


@pytest.mark.parametrize("factored", [False, True])
def test_k6d_converges_on_the_first_checks(dev, factored):
    """tol inf converges before any iteration (numit 0, x_0); a tol above the first residual
    converges at the first check (numit 1) and returns the iterate of that check, x_0 again."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, torch.float32, factored)
    kw = dict(n_true=n, factored=factored)
    x0 = tp.resident_cv_dsvm(q, lab, 0.5, 0.05, 0.99 / na, -1.0, 0, **kw)[0]
    for tol, numit in ((float("inf"), 0), (1e30, 1)):
        got = tp.resident_cv_dsvm(q, lab, 0.5, 0.05, 0.99 / na, tol, 50, **kw)
        want = tp.resident_cv_dsvm_plain(q, lab, 0.5, 0.05, 0.99 / na, tol, 50, **kw)
        assert int(got[1]) == int(want[1]) == numit and bool(got[3]) and bool(want[3])
        assert torch.equal(got[0], x0) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("factored", [False, True])
def test_k6d_nan_in_q_stops_unconverged_with_the_boxed_step(dev, factored):
    """A NaN in Q (or B) makes the first residual NaN: the solve stops after one iteration,
    not converged, and returns the boxed step x_1, as the plain version does. The warm-up's
    Q x0 carries the NaN (NaN * 0), so x_0, labels'x_0, y and with them every coordinate of
    x_1 are NaN, on both."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    q, lab, n, na = pd_case(dev, torch.float32, factored)
    q[0, 0] = float("nan")
    kw = dict(n_true=n, record=True, factored=factored)
    got = tp.resident_cv_dsvm(q, lab, 0.5, 0.05, 0.99 / na, 1e-6, 100, **kw)
    want = tp.resident_cv_dsvm_plain(q, lab, 0.5, 0.05, 0.99 / na, 1e-6, 100, **kw)
    assert int(got[1]) == int(want[1]) == 1 and not bool(got[3]) and not bool(want[3])
    assert math.isnan(float(got[2])) and math.isnan(float(got[4][0][0]))
    nan = torch.isnan(got[0])
    assert bool(nan.any()) and torch.equal(nan, torch.isnan(want[0]))
    assert bool(nan.all())


def test_dual_svm_resident_is_one_k6b_and_one_k6d_launch(dev, tmp_path):
    """dual_svm --resident on heart_scale's stand-in (dense Q) at C 0.1 and 1: one K6b, one
    K6c and one K6d launch each, no K6a launch; the engine path launches none."""
    from adaprox_tpu_torch.experiments import dual_svm
    from adaprox_tpu_torch.ops import resident_mp as tm
    from adaprox_tpu_torch.ops import resident_pd as tp
    from adaprox_tpu_torch.utils.logging import read_jsonl

    counters = (tp.resident_adapdm_dsvm, tp.resident_adapdm_dsvm_sweep,
                tm.resident_mp_dsvm_sweep, tp.resident_cv_dsvm)
    before = [c.launches for c in counters]
    dual_svm.main(["--resident", "--datasets", "heart_scale", "--maxit", "300", "--device",
                   "cuda", "--outdir", str(tmp_path), "--no-plot"])
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 2, 2, 2]
    for big_c in ("0.1", "1.0"):
        rows = read_jsonl(tmp_path / f"heart_scale_C_{big_c}.jsonl")
        names = list(dict.fromkeys(r["method"] for r in rows if "it" in r))
        assert names == ([f"AdaPDM (t={t})" for t in dual_svm.T_VALUES]
                         + [f"Malitsky-Pock (t={t})" for t in dual_svm.T_VALUES] + ["Condat-Vu"])
        assert all(list(r) == dual_svm.KEYS for r in rows if "it" in r)
        assert rows[-2]["fast_path"] == "resident"
        assert rows[-2]["fast_methods"] == ["AdaPDM t-sweep (resident)", "MP t-sweep (resident)",
                                            "Condat-Vu"]
    before = [c.launches for c in counters]
    dual_svm.main(["--datasets", "heart_scale", "--C", "0.1", "--maxit", "20", "--device",
                   "cuda", "--outdir", str(tmp_path / "engine"), "--no-plot"])
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 0, 0]


# K6c against its plain version, exact Bregman form (the card's default), tol -1: on the CPU
# the plain version in f32 (Q f32 or bf16) first took another trial count than in f64, or
# parted from it by more than 1e-3 of its row's largest value (gamma, sigma, norm_res), at
# iteration 63 to 300 on pd_case (dense and factored, t = 2 first; 1.48-1.51 trials an
# iteration). The rows are held over 40 iterations: trial counts equal, the rest within 1e-3.
MP_HORIZON = 40


def _mp_rows_close(got, want, horizon):
    assert torch.equal(got[3][..., :horizon], want[3][..., :horizon])  # the trial counts
    for k in (0, 1, 2, 4):
        u, w = got[k][..., :horizon], want[k][..., :horizon]
        assert float((u - w).abs().max()) <= PD_RTOL * float(w.abs().max())


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6c_matches_plain_on_card(dev, dtype, factored):
    from adaprox_tpu_torch.ops import resident_mp as tm

    q, lab, n, na = pd_case(dev, dtype, factored)
    kw = dict(n_true=n, record=True, factored=factored, exact_bregman=True)
    before = tm.resident_mp_dsvm_sweep.launches
    got = tm.resident_mp_dsvm_sweep(q, lab, 0.5, PD_TS, 1 / na, -1.0, MP_HORIZON, **kw)
    torch.cuda.synchronize()
    assert tm.resident_mp_dsvm_sweep.launches == before + 1
    want = tm.resident_mp_dsvm_sweep_plain(q, lab, 0.5, PD_TS, 1 / na, -1.0, MP_HORIZON, **kw)
    assert got[0].dtype == torch.float32 and got[5][0].shape == (3, MP_HORIZON)
    assert got[1].tolist() == want[1].tolist() == [MP_HORIZON] * 3
    assert not bool(got[3].any()) and not bool(got[4].any())
    _mp_rows_close(got[5], want[5], MP_HORIZON)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())
    assert not bool(got[0][:, n:].any())  # the padded coordinates stay exactly 0


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("factored", [False, True])
def test_k6c_rows_are_one_row_launches_bit_for_bit(dev, factored, exact):
    """Each row of the sweep is its one-row launch, bit for bit, solved to tol 1e-4 with
    records; two launches give the same bits."""
    from adaprox_tpu_torch.ops import resident_mp as tm

    q, lab, n, na = pd_case(dev, torch.float32, factored)
    kw = dict(n_true=n, record=True, factored=factored, exact_bregman=exact)
    sweep = tm.resident_mp_dsvm_sweep(q, lab, 0.5, PD_TS, 1 / na, 1e-4, 3000, **kw)
    again = tm.resident_mp_dsvm_sweep(q, lab, 0.5, PD_TS, 1 / na, 1e-4, 3000, **kw)
    flat = lambda out: list(out[:5]) + list(out[5])  # noqa: E731
    assert all(torch.equal(u, w) for u, w in zip(flat(sweep), flat(again)))
    for j, t in enumerate(PD_TS):
        one = tm.resident_mp_dsvm_sweep(q, lab, 0.5, [t], 1 / na, 1e-4, 3000, **kw)
        assert all(torch.equal(u[0], w[j]) for u, w in zip(flat(one), flat(sweep)))


def test_k6c_zero_iterations_and_refusals(dev):
    from adaprox_tpu_torch.ops import resident_mp as tm

    q, lab, n, na = pd_case(dev, torch.float32, False)
    x, numit, nres, conv, lsf, hists = tm.resident_mp_dsvm_sweep(q, lab, 0.5, [1.0], 1 / na, 0.0,
                                                                 0, n_true=n, record=True)
    assert int(numit[0]) == 0 and float(nres[0]) == float("inf") and not bool(conv[0])
    assert not bool(x.any()) and not bool(lsf[0]) and hists[0].shape == (1, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tm.resident_mp_dsvm_sweep(q.double(), lab, 0.5, [1.0], 1 / na, 0.0, 3)
    with pytest.raises(TypeError, match="float32 labels"):
        tm.resident_mp_dsvm_sweep(q, lab.double(), 0.5, [1.0], 1 / na, 0.0, 3)
    with pytest.raises(ValueError, match="must be positive"):
        tm.resident_mp_dsvm_sweep(q, lab, 0.5, [1.0], 0.0, 0.0, 3)
    with pytest.raises(ValueError, match="one dimension"):
        tm.resident_mp_dsvm_sweep(q, lab, 0.5, [[1.0, 2.0]], 1 / na, 0.0, 3)
    with pytest.raises(ValueError, match="one dimension"):
        tm.resident_mp_dsvm_sweep(q, lab, 0.5, [], 1 / na, 0.0, 3)
    with pytest.raises(ValueError, match="square"):
        tm.resident_mp_dsvm_sweep(q[:, :128], lab, 0.5, [1.0], 1 / na, 0.0, 3)
    with pytest.raises(ValueError, match="labels"):
        tm.resident_mp_dsvm_sweep(q[:128, :128], lab, 0.5, [1.0], 1 / na, 0.0, 3, factored=True)


def test_k6c_exact_bregman_large_f_on_card(dev):
    """The large-|f| f32 instance of the JAX suite (tests/test_solvers.py: 256 points, B 256x16
    times 2, t 0.15, tol 1e-5, maxit 1500): the exact form's residual is below the raw form's
    tenth, or at tol."""
    import numpy as np

    from adaprox_tpu_torch.ops import resident_mp as tm

    rng = np.random.default_rng(1)
    m, d = 256, 16
    bmat = rng.standard_normal((m, d)) * 2.0
    labels = np.where(rng.standard_normal(m) > 0, 1.0, -1.0)
    bmat *= labels[:, None]
    q = torch.as_tensor(np.pad(bmat, ((0, 0), (0, 128 - d))), dtype=torch.float32, device=dev)
    lab = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    na = float(np.linalg.norm(labels))
    res = {eb: float(tm.resident_mp_dsvm_sweep(q, lab, 0.1, [0.15], 1 / na, 1e-5, 1500, n_true=m,
                                               factored=True, exact_bregman=eb)[2][0])
           for eb in (True, False)}
    assert res[True] < res[False] / 10 or res[True] <= 1e-5


# -- K6a, K6b and K6c on thread-block clusters ----------------------------------------------------

# the dual_svm driver's shapes: heart_scale's dense Q (270 points -> 384), svmguide3's (1243 ->
# 1280), mushrooms' factored B (8124 x 112 -> 8192 x 128); random data of those shapes
K6_SHAPES = {"384 dense": dict(n=270, d=13, n_pad=384, factored=False),
             "1280 dense": dict(n=1243, d=21, n_pad=1280, factored=False),
             "8192x128 factored": dict(n=8124, d=112, n_pad=8192, factored=True)}


def _k6(core):
    """(sweep, plain, the core's first-step argument from norm_a, extra keywords)."""
    from adaprox_tpu_torch.ops import resident_mp as tm
    from adaprox_tpu_torch.ops import resident_pd as tp

    if core == "adapdm":
        return (tp.resident_adapdm_dsvm_sweep, tp.resident_adapdm_dsvm_sweep_plain,
                lambda na: na, {})
    return (tm.resident_mp_dsvm_sweep, tm.resident_mp_dsvm_sweep_plain, lambda na: 1 / na,
            {"exact_bregman": True})


def _k6_case(dev, shape, dtype=torch.float32):
    kw = dict(K6_SHAPES[shape])
    factored = kw.pop("factored")
    q, lab, n, na = pd_case(dev, dtype, factored, seed=11, **kw)
    return q, lab, n, na, factored


def _k6_flat(out):
    return [u for v in out for u in (v if isinstance(v, tuple) else (v,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(K6_SHAPES))
@pytest.mark.parametrize("core", ["adapdm", "mp"])
def test_k6_cluster_layouts_match_plain(dev, core, shape, dtype):
    """At the driver's three shapes: heart_scale's 384^2 fits whole in the shared memory of its
    cluster (f32 at C 4); svmguide3's 1280^2 and mushrooms' 8192 x 128 do not, and the CTAs of
    8 read the rows they do not hold from device memory. Each is held to its plain version
    over the horizons above, its padded coordinates exactly 0, and each row equals its
    one-row launch bit for bit."""
    from adaprox_tpu_torch.ops import resident_pd as tp

    sweep, plain, p2_of, extra = _k6(core)
    q, lab, n, na, factored = _k6_case(dev, shape, dtype)
    plan = tp.dsvm_grid_plan(q, core, len(PD_TS), factored=factored)
    assert plan["fits"] and plan["clusters"] == len(PD_TS)
    assert plan["rows_held"] <= plan["rows_per_cta"] and plan["cluster"] in (1, 2, 4, 8)
    if shape == "384 dense" and dtype == torch.float32:
        assert plan["whole"] and plan["cluster"] == 4
    if shape != "384 dense":
        assert not plan["whole"] and plan["cluster"] == 8
    horizon = PD_HORIZON if core == "adapdm" else MP_HORIZON
    kw = dict(n_true=n, record=True, factored=factored, **extra)
    args = (q, lab, 0.5, PD_TS, p2_of(na), -1.0, horizon)
    got = sweep(*args, **kw)
    want = plain(*args, **kw)
    if core == "adapdm":
        _pd_rows_close(got[4:], want[4:], horizon)
    else:
        _mp_rows_close(got[5], want[5], horizon)
    assert float((got[0] - want[0]).abs().max()) <= PD_RTOL * float(want[0].abs().max())
    assert not bool(got[0][:, n:].any())
    for j, t in enumerate(PD_TS):
        one = sweep(q, lab, 0.5, [t], p2_of(na), -1.0, horizon, **kw)
        assert all(torch.equal(u[0], w[j]) for u, w in zip(_k6_flat(one), _k6_flat(got)))


@pytest.mark.parametrize("shape", list(K6_SHAPES))
@pytest.mark.parametrize("core", ["adapdm", "mp"])
def test_k6_reversed_and_doubled_ts(dev, core, shape):
    """The rows run at once, each on whichever cluster takes it: the driver's 12 couplings
    reversed give the rows reversed, and the 12 twice over (24 rows, more than the clusters
    that run at once at C 8) give each row's bits twice, solved to tol 1e-4."""
    from adaprox_tpu_torch.experiments.dual_svm import T_VALUES
    from adaprox_tpu_torch.ops import resident_pd as tp

    sweep, _, p2_of, extra = _k6(core)
    q, lab, n, na, factored = _k6_case(dev, shape)
    kw = dict(n_true=n, record=True, factored=factored, **extra)
    base = sweep(q, lab, 0.5, T_VALUES, p2_of(na), 1e-4, 2000, **kw)
    rev = sweep(q, lab, 0.5, T_VALUES[::-1], p2_of(na), 1e-4, 2000, **kw)
    assert all(torch.equal(u, w.flip(0)) for u, w in zip(_k6_flat(rev), _k6_flat(base)))
    twice = sweep(q, lab, 0.5, T_VALUES * 2, p2_of(na), 1e-4, 2000, **kw)
    if shape != "384 dense":
        assert tp.dsvm_grid_plan(q, core, 24, factored=factored)["clusters"] < 24
    for u, w in zip(_k6_flat(twice), _k6_flat(base)):
        assert torch.equal(u[:12], w) and torch.equal(u[12:], w)


def test_k6_refuses_a_layout_it_cannot_hold(dev):
    """Vectors that do not fit a CTA's shared memory at C = 8 are refused, not run: a dense
    N of 10240 (six N-vectors, 240 KB) and a factored d of 20000 (B'x and its partials,
    240 KB)."""
    from adaprox_tpu_torch.ops import resident_mp as tm
    from adaprox_tpu_torch.ops import resident_pd as tp

    lab = torch.ones(10240, device=dev)
    q = torch.zeros(10240, 10240, device=dev)
    assert not tp.dsvm_grid_plan(q, "adapdm", 1)["fits"]
    with pytest.raises(ValueError, match="refused"):
        tp.resident_adapdm_dsvm(q, lab, 0.5, 1.0, 1.0, 0.0, 3)
    b = torch.zeros(64, 20000, device=dev)
    assert not tp.dsvm_grid_plan(b, "mp", 1, factored=True)["fits"]
    with pytest.raises(ValueError, match="refused"):
        tm.resident_mp_dsvm_sweep(b, lab[:64], 0.5, [1.0], 1.0, 0.0, 3, factored=True)
    with pytest.raises(ValueError, match="refused"):
        tp.resident_adapdm_dsvm_sweep(b, lab[:64], 0.5, [1.0], 1.0, 0.0, 3, factored=True)


@pytest.mark.parametrize("shape", ["384 dense", "8192x128 factored"])
def test_k6_check_fails_a_kernel_that_skips_a_row_block(dev, tmp_path, monkeypatch, shape):
    """The plain comparison guards every CTA's share: a kernel built so that rank 1 of each
    cluster owns no rows (its block of Q or B, its slice of Q x, its rows' vectors skipped)
    fails it, where the kernel as built passes."""
    import shutil

    from adaprox_tpu_torch.ops import resident_pd as tp

    src = tp.GRID_SOURCE.read_text()
    line = "  c.rows = static_cast<int>(left < rows_per ? left : rows_per);\n"
    assert src.count(line) == 1
    for header in tp.GRID_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, tmp_path / header.name)
    mutant = tmp_path / "resident_dsvm_grid_skip_rank1.cu"
    mutant.write_text(src.replace(line, line.replace(
        "static_cast<int>(left", "rank == 1 ? 0 : static_cast<int>(left")))
    q, lab, n, na, factored = _k6_case(dev, shape)
    assert tp.dsvm_grid_plan(q, "adapdm", len(PD_TS), factored=factored)["cluster"] >= 2
    kw = dict(n_true=n, record=True, factored=factored)
    args = (q, lab, 0.5, PD_TS, na, -1.0, PD_HORIZON)
    want = tp.resident_adapdm_dsvm_sweep_plain(*args, **kw)
    _pd_rows_close(tp.resident_adapdm_dsvm_sweep(*args, **kw)[4:], want[4:], PD_HORIZON)
    monkeypatch.setattr(tp, "GRID_SOURCE", mutant)
    got = tp.resident_adapdm_dsvm_sweep(*args, **kw)
    torch.cuda.synchronize()
    err = (got[5] - want[5]).abs().amax(-1) / want[5].abs().amax(-1)
    assert not bool((err <= PD_RTOL).all())


# -- K7d, the f = 0 family's Condat-Vu ----------------------------------------------------------

# K7d against its plain version, tol -1, 300 iterations: on the CPU the plain version in f32
# (A f32 or bf16) parted from f64 by at most 7.9e-7 of each history row's largest value and
# 7.0e-7 of max |x| on k7d_case (l2 and l1); the card sums in another order than the plain
# version. Held at 1e-5.
K7D_RTOL = 1e-5


def k7d_case(dev, dtype, m=500, n=100, seed=6):
    """(a, bv, gamma, sigma, n) of a square-root-lasso problem: A (m, n) Gaussian / sqrt(n),
    bv = A w + noise with a sparse w, zero-padded to (512, 128) as the drivers pad; a in
    ``dtype`` storage, bv f32; the Condat-Vu steps from the Frobenius norm (Lf = 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)) / n**0.5
    w = rng.standard_normal(n) * (rng.random(n) < 0.2)
    bv = a @ w + 0.1 * rng.standard_normal(m)
    a_pad, b_pad = np.zeros((512, 128)), np.zeros(512)
    a_pad[:m, :n], b_pad[:m] = a, bv
    na = float(np.linalg.norm(a))
    return (torch.as_tensor(a_pad, dtype=torch.float32, device=dev).to(dtype),
            torch.as_tensor(b_pad, dtype=torch.float32, device=dev), 1.0 / na, 0.99 / na, n)


@pytest.mark.parametrize("h_kind", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7d_matches_plain_on_card(dev, dtype, h_kind):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, gamma, sigma, n = k7d_case(dev, dtype)
    before = tf.resident_condat_vu.launches
    got = tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, -1.0, 300, record=True, h_kind=h_kind)
    torch.cuda.synchronize()
    assert tf.resident_condat_vu.launches == before + 1
    want = tf.resident_condat_vu_plain(a, bv, 0.1, gamma, sigma, -1.0, 300, record=True,
                                       h_kind=h_kind)
    assert got[0].dtype == torch.float32 and got[4][0].shape == (300,)
    assert int(got[1]) == int(want[1]) == 300 and not bool(got[3])
    for u, w in zip(got[4], want[4]):
        assert float((u - w).abs().max()) <= K7D_RTOL * float(w.abs().max())
    assert float((got[0] - want[0]).abs().max()) <= K7D_RTOL * float(want[0].abs().max())
    assert not bool(got[0][n:].any())  # the padded coordinates stay exactly 0


def test_k7d_odd_shapes_take_scalar_loads(dev):
    """Rows that are not whole 16-byte groups (517 x 13: the scalar instantiations)."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a = torch.randn(517, 13, generator=gen, device=dev) / 13**0.5
    bv = torch.randn(517, generator=gen, device=dev)
    na = float(torch.linalg.matrix_norm(a))
    for h_kind in ("l2", "l1"):
        for dtype in (torch.float32, torch.bfloat16):
            got = tf.resident_condat_vu(a.to(dtype), bv, 0.1, 1 / na, 0.99 / na, -1.0, 200,
                                        record=True, h_kind=h_kind)
            want = tf.resident_condat_vu_plain(a.to(dtype), bv, 0.1, 1 / na, 0.99 / na, -1.0,
                                               200, record=True, h_kind=h_kind)
            for u, w in zip(got[4], want[4]):
                assert float((u - w).abs().max()) <= K7D_RTOL * float(w.abs().max())
            assert float((got[0] - want[0]).abs().max()) <= K7D_RTOL * float(
                want[0].abs().max())


def test_k7d_is_repeatable_and_returns_the_checked_iterate(dev):
    """Two launches give the same bits; converged at iteration k, the solve returns the x
    of the check, which a run capped at k - 1 iterations returns; maxit 0 returns the
    warm-up's x = 0 with an infinite residual."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, gamma, sigma, _ = k7d_case(dev, torch.float32)
    one = tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, 1e-3, 20000, record=True)
    two = tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, 1e-3, 20000, record=True)
    assert all(torch.equal(u, w) for u, w in zip(one[:4], two[:4]))
    assert all(torch.equal(u, w) for u, w in zip(one[4], two[4]))
    k = int(one[1])
    assert bool(one[3]) and float(one[2]) <= 1e-3 and 1 < k < 20000
    assert float(one[4][0][k - 1]) <= 1e-3 and not bool(one[4][0][k:].any())
    capped = tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, -1.0, k - 1)
    assert torch.equal(capped[0], one[0])
    x, numit, nres, conv = tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, 0.0, 0)
    assert int(numit) == 0 and float(nres) == float("inf") and not bool(conv)
    assert not bool(x.any())


def test_k7d_refusals(dev):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, gamma, sigma, _ = k7d_case(dev, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tf.resident_condat_vu(a.double(), bv, 0.1, gamma, sigma, 0.0, 3)
    with pytest.raises(TypeError, match="float32 bv"):
        tf.resident_condat_vu(a, bv.double(), 0.1, gamma, sigma, 0.0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tf.resident_condat_vu(a.t().contiguous().t(), bv, 0.1, gamma, sigma, 0.0, 3)
    with pytest.raises(ValueError, match="h_kind"):
        tf.resident_condat_vu(a, bv, 0.1, gamma, sigma, 0.0, 3, h_kind="linf")


# -- K7a, the f = 0 family's Malitsky-Pock and AdaPDM+ t-sweeps -------------------------------

# K7a against its plain version, tol -1, on the drivers' padded inputs: the couplings, the
# horizon over which the trial counts are held equal and the bounds on the rows and on x
# are the ones calibrated on the CPU in adaprox_tpu_torch/experiments/k7a_calibration.py.


def k7a_inputs(dev, name, dtype):
    """(a, bv, eta0, n) of the square-root lasso driver's resident call on ``name``'s
    stand-in: [X 1] and y zero-padded to multiples of 128, A in ``dtype``, bv f32."""
    from adaprox_tpu_torch.convert import sqrt_lasso_from_numpy
    from adaprox_tpu_torch.experiments import square_root_lasso

    x, y, _ = square_root_lasso.load(name)
    _, _, h, a_op, norm_a = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device=dev,
                                                  dtype=torch.float32)
    a, bv = square_root_lasso.resident_inputs(a_op.a, -h.b)
    return a.to(dtype), bv, norm_a, x.shape[1] + 1


def _k7a(core):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    if core == "mp":
        return tf.resident_mpls_sweep, tf.resident_mpls_sweep_plain
    return tf.resident_adapdmp_sweep, tf.resident_adapdmp_sweep_plain


@pytest.mark.parametrize("h_kind", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["housing_scale", "abalone", "cpusmall_scale"])
@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7a_matches_plain_on_card(dev, core, name, dtype, h_kind):
    """Each core at the drivers' three padded shapes (512x128, 4224x128, 8192x128), over
    the calibrated horizon: numit, the trial counts and ls_failed equal, the gamma,
    sigma, norm_res and objective rows within K7A_RTOL and x within K7A_X_RTOL, the padded
    coordinates of x 0."""
    kernel, plain = _k7a(core)
    a, bv, norm_a, n = k7a_inputs(dev, name, dtype)
    p2 = 1.0 if core == "mp" else norm_a
    args = (a, bv, 10.0, K7A_TS, p2, -1.0, K7A_HORIZON)
    before = kernel.launches
    got = kernel(*args, record=True, h_kind=h_kind)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, record=True, h_kind=h_kind)
    rows = len(K7A_TS)
    assert got[0].dtype == torch.float32 and got[5][0].shape == (rows, K7A_HORIZON)
    assert got[1].tolist() == want[1].tolist() == [K7A_HORIZON] * rows
    assert torch.equal(got[4], want[4]) and torch.equal(got[5][3], want[5][3])
    for k in (0, 1, 2, 4):
        u, w = got[5][k], want[5][k]
        assert float((u - w).abs().max()) <= K7A_RTOL * float(w.abs().max()), k
    assert float((got[0] - want[0]).abs().max()) <= K7A_X_RTOL * max(
        float(want[0].abs().max()), 1e-30)
    assert not bool(got[0][:, n:].any())


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7a_rows_are_one_row_launches_and_repeatable(dev, core):
    """At the drivers' tol 1e-5: two launches give the same bits, and each row of a
    sweep equals its one-row launch bit for bit (the rows run in turn on the same
    grid)."""
    kernel, _ = _k7a(core)
    a, bv, norm_a, _ = k7a_inputs(dev, "housing_scale", torch.float32)
    p2 = 1.0 if core == "mp" else norm_a
    for h_kind in ("l2", "l1"):
        args = (a, bv, 10.0, K7A_TS, p2, 1e-5, 2000)
        one = kernel(*args, record=True, h_kind=h_kind)
        two = kernel(*args, record=True, h_kind=h_kind)
        flat = lambda out: list(out[:5]) + list(out[5])  # noqa: E731
        assert all(torch.equal(u, w) for u, w in zip(flat(one), flat(two)))
        for j, t in enumerate(K7A_TS):
            row = kernel(a, bv, 10.0, [t], p2, 1e-5, 2000, record=True, h_kind=h_kind)
            assert all(torch.equal(u[0], w[j]) for u, w in zip(flat(row), flat(one)))


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7a_returns_the_cores_iterate_and_zero_iterations(dev, core):
    """Converged, MP returns the last accepted iterate and AdaPDM+ the iterate at the
    check: both equal what a run capped at numit returns (MP) or numit - 1 returns as its
    non-converged x (AdaPDM+). maxit 0 returns x = 0, numit 0 and an infinite residual."""
    kernel, _ = _k7a(core)
    a, bv, norm_a, _ = k7a_inputs(dev, "housing_scale", torch.float32)
    p2 = 1.0 if core == "mp" else norm_a
    out = kernel(a, bv, 10.0, [1.0], p2, 1e-4, 5000, record=True)
    k = int(out[1][0])
    assert bool(out[3][0]) and 1 < k < 5000 and not bool(out[5][0][0, k:].any())
    capped = kernel(a, bv, 10.0, [1.0], p2, -1.0, k if core == "mp" else k - 1)
    assert torch.equal(capped[0], out[0])
    x, numit, nres, conv, lsf = kernel(a, bv, 10.0, [1.0, 2.0], p2, 0.0, 0)
    assert numit.tolist() == [0, 0] and bool(torch.isinf(nres).all()) and not bool(conv.any())
    assert not bool(x.any()) and not bool(lsf.any())


def test_k7a_refusals(dev):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, norm_a, _ = k7a_inputs(dev, "housing_scale", torch.float32)
    for fn, p2 in ((tf.resident_mpls_sweep, 1.0), (tf.resident_adapdmp_sweep, norm_a)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(a.double(), bv, 10.0, K7A_TS, p2, 0.0, 3)
        with pytest.raises(TypeError, match="float32 bv"):
            fn(a, bv.double(), 10.0, K7A_TS, p2, 0.0, 3)
        with pytest.raises(ValueError, match="contiguous"):
            fn(a.t().contiguous().t(), bv, 10.0, K7A_TS, p2, 0.0, 3)
        with pytest.raises(ValueError, match="positive"):
            fn(a, bv, 10.0, K7A_TS, -p2, 0.0, 3)
        with pytest.raises(ValueError, match="coupling t"):
            fn(a, bv, 10.0, [0.0], p2, 0.0, 3)


@pytest.mark.parametrize("driver", ["square_root_lasso", "least_absolute_deviation"])
def test_sqrt_lasso_drivers_resident_is_one_k7d_launch(dev, tmp_path, driver):
    """--resident on housing_scale's stand-in: one K7d, one K7a MP and one K7a AdaPDM+
    launch, and the 31 rows with JAX's names, keys and fast_methods; the engine path
    launches none of them and writes 31 rows too."""
    import importlib

    from adaprox_tpu_torch.experiments.square_root_lasso import T_VALUES
    from adaprox_tpu_torch.ops import resident_f0 as tf
    from adaprox_tpu_torch.utils.logging import read_jsonl

    kernels = (tf.resident_condat_vu, tf.resident_mpls_sweep, tf.resident_adapdmp_sweep)
    mod = importlib.import_module(f"adaprox_tpu_torch.experiments.{driver}")
    before = [k.launches for k in kernels]
    mod.main(["--resident", "--datasets", "housing_scale", "--maxit", "300", "--device", "cuda",
              "--outdir", str(tmp_path), "--no-plot"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    rows = read_jsonl(tmp_path / "housing_scale.jsonl")
    names = list(dict.fromkeys(r["method"] for r in rows if "norm_res" in r))
    assert names == (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in T_VALUES]
                     + [f"AdaPDM+ (t={t})" for t in T_VALUES])
    assert all(list(r) == ["method", "norm_res", "A_evals", "At_evals"] for r in rows
               if "norm_res" in r)
    assert rows[-2]["fast_path"] == "resident" and rows[-2]["fast_methods"] == [
        "Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
    before = [k.launches for k in kernels]
    mod.main(["--datasets", "housing_scale", "--maxit", "20", "--device", "cuda", "--outdir",
              str(tmp_path / "engine"), "--no-plot"])
    assert [k.launches for k in kernels] == before
    rows = read_jsonl(tmp_path / "engine" / "housing_scale.jsonl")
    assert len({r["method"] for r in rows if "norm_res" in r}) == 31


# -- K7b and K7c, the f = 0 dataset grids ------------------------------------------------------

# K7b against its plain version over K7a's calibrated horizon and bounds (the datasets'
# padding to the common shape adds exact zeros to every sum of the plain version); K7c
# against its plain version over 300 iterations at K7D_RTOL on two k7d_case problems (seeds
# 6 and 7: on the CPU the f32 plain version parted from f64 by at most 1.2e-6 of a history
# row's largest value and 7.0e-7 of max |x| there, l2 and l1, A f32 and bf16).
F0_GRID_DATASETS = ["housing_scale", "abalone", "cpusmall_scale"]


def grid_stack(dev, dtype, names=F0_GRID_DATASETS):
    """(a_stack, bv_stack, norm_as) of the drivers' --resident-grid on the stand-ins: [X 1]
    and y zero-padded to the common 8192 x 128, A in ``dtype``, bv f32."""
    from adaprox_tpu_torch.experiments import square_root_lasso

    _, a, bv, norms, _ = square_root_lasso.grid_inputs(list(names), device=dev,
                                                       dtype=torch.float32)
    return a.to(dtype), bv, norms


def _k7b(core):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    if core == "mp":
        return tf.resident_mpls_grid, tf.resident_mpls_grid_plain, tf.resident_mpls_sweep
    return tf.resident_adapdmp_grid, tf.resident_adapdmp_grid_plain, tf.resident_adapdmp_sweep


def _flat(out):
    return list(out[:5]) + list(out[5])


@pytest.mark.parametrize("h_kind", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7b_matches_plain_on_card(dev, core, dtype, h_kind):
    """Each core over the three stand-ins padded to 8192 x 128, the couplings K7A_TS, over
    the calibrated horizon: numit, the trial counts and ls_failed equal, each cell's gamma,
    sigma, norm_res and objective rows within K7A_RTOL and x within K7A_X_RTOL, the padded
    coordinates of x 0; one launch."""
    kernel, plain, _ = _k7b(core)
    a, bv, norms = grid_stack(dev, dtype)
    p2s = [1.0] * 3 if core == "mp" else norms
    args = (a, bv, [10.0] * 3, K7A_TS, p2s, -1.0, K7A_HORIZON)
    before = kernel.launches
    got = kernel(*args, record=True, h_kind=h_kind)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*args, record=True, h_kind=h_kind)
    cells = (3, len(K7A_TS))
    assert got[0].dtype == torch.float32 and got[5][0].shape == cells + (K7A_HORIZON,)
    assert got[1].tolist() == want[1].tolist() == [[K7A_HORIZON] * cells[1]] * 3
    assert torch.equal(got[4], want[4]) and torch.equal(got[5][3], want[5][3])
    for k in (0, 1, 2, 4):
        err = (got[5][k] - want[5][k]).abs().amax(-1) / want[5][k].abs().amax(-1)
        assert float(err.max()) <= K7A_RTOL, k
    for d, n in enumerate((14, 9, 13)):  # [X 1]'s columns: housing 13 + 1, abalone 8 + 1, ...
        assert float((got[0][d] - want[0][d]).abs().max()) <= K7A_X_RTOL * max(
            float(want[0][d].abs().max()), 1e-30)
        assert not bool(got[0][d, :, n:].any())


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7b_cells_are_one_row_launches_and_repeatable(dev, core):
    """At the drivers' tol 1e-5: two launches give the same bits, and each cell equals the
    one-row K7a launch on its dataset's slice with its lam and p2, bit for bit."""
    kernel, _, sweep = _k7b(core)
    a, bv, norms = grid_stack(dev, torch.float32)
    p2s = [1.0] * 3 if core == "mp" else norms
    lams = [10.0, 5.0, 20.0]
    for h_kind in ("l2", "l1"):
        args = (a, bv, lams, K7A_TS, p2s, 1e-5, 2000)
        one, two = (kernel(*args, record=True, h_kind=h_kind) for _ in range(2))
        assert all(torch.equal(u, w) for u, w in zip(_flat(one), _flat(two)))
        for d in range(3):
            for j, t in enumerate(K7A_TS):
                row = sweep(a[d], bv[d], lams[d], [t], p2s[d], 1e-5, 2000, record=True,
                            h_kind=h_kind)
                assert all(torch.equal(u[0], w[d, j]) for u, w in zip(_flat(row), _flat(one)))


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7b_broken_first_dataset_leaves_the_second_alone(dev, core):
    """A first dataset that breaks down (an infinite entry of bv: NaN from the first dual
    step) leaves NaN in every scratch slot; the next dataset's cells still equal those of a
    grid whose first dataset converges, and their one-row K7a launches, bit for bit."""
    kernel, _, sweep = _k7b(core)
    a, bv, norms = grid_stack(dev, torch.float32, names=("housing_scale", "abalone"))
    p2s = [1.0] * 2 if core == "mp" else norms
    broken = bv.clone()
    broken[0, 0] = float("inf")
    for h_kind in ("l2", "l1"):
        bad, good = (kernel(a, b, [10.0, 10.0], K7A_TS, p2s, 1e-5, 1000, record=True,
                            h_kind=h_kind) for b in (broken, bv))
        assert bad[1][0].tolist() == [1] * len(K7A_TS) and bool(torch.isnan(bad[2][0]).all())
        assert bool(torch.isnan(bad[0][0]).all())
        assert all(torch.equal(u[1], w[1]) for u, w in zip(_flat(bad), _flat(good)))
        row = sweep(a[1], bv[1], 10.0, K7A_TS, p2s[1], 1e-5, 1000, record=True, h_kind=h_kind)
        assert all(torch.equal(u, w[1]) for u, w in zip(_flat(row), _flat(bad)))


def cv_grid_case(dev, dtype):
    """k7d_case at seeds 6 and 7, stacked: (a_stack (2, 512, 128), bv_stack, gammas, sigmas,
    the unpadded column count)."""
    cases = [k7d_case(dev, dtype, seed=seed) for seed in (6, 7)]
    return (torch.stack([c[0] for c in cases]), torch.stack([c[1] for c in cases]),
            [c[2] for c in cases], [c[3] for c in cases], cases[0][4])


@pytest.mark.parametrize("h_kind", ["l2", "l1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7c_matches_plain_on_card(dev, dtype, h_kind):
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, gammas, sigmas, n = cv_grid_case(dev, dtype)
    before = tf.resident_cv_grid.launches
    got = tf.resident_cv_grid(a, bv, [0.1, 0.1], gammas, sigmas, -1.0, 300, h_kind=h_kind)
    torch.cuda.synchronize()
    assert tf.resident_cv_grid.launches == before + 1
    want = tf.resident_cv_grid_plain(a, bv, [0.1, 0.1], gammas, sigmas, -1.0, 300,
                                     h_kind=h_kind)
    assert got[0].dtype == torch.float32 and got[4][0].shape == (2, 300)
    assert got[1].tolist() == want[1].tolist() == [300, 300] and not bool(got[3].any())
    for u, w in zip(got[4], want[4]):
        assert float(((u - w).abs().amax(1) / w.abs().amax(1)).max()) <= K7D_RTOL
    xe = (got[0] - want[0]).abs().amax(1) / want[0].abs().amax(1)
    assert float(xe.max()) <= K7D_RTOL and not bool(got[0][:, n:].any())


def test_k7c_rows_are_k7d_launches_and_repeatable(dev):
    """Each dataset's Condat-Vu equals the K7d launch on its slice bit for bit, at the
    drivers' tol 1e-5 (housing_scale and abalone converge with l2, cpusmall_scale runs on),
    and two launches give the same bits; a first dataset that breaks down (an infinite bv
    entry) leaves the next one's solve as it was."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, norms = grid_stack(dev, torch.float32)
    gammas, sigmas = [1 / na for na in norms], [0.99 / na for na in norms]
    for h_kind in ("l2", "l1"):
        args = (a, bv, [10.0] * 3, gammas, sigmas, 1e-5, 5000)
        one, two = (tf.resident_cv_grid(*args, h_kind=h_kind) for _ in range(2))
        flat = lambda out: list(out[:4]) + list(out[4])  # noqa: E731
        assert all(torch.equal(u, w) for u, w in zip(flat(one), flat(two)))
        for d in range(3):
            k7d = tf.resident_condat_vu(a[d], bv[d], 10.0, gammas[d], sigmas[d], 1e-5, 5000,
                                        record=True, h_kind=h_kind)
            assert all(torch.equal(u[d], w) for u, w in zip(flat(one), flat(k7d)))
        broken = bv.clone()
        broken[0, 0] = float("inf")
        bad = tf.resident_cv_grid(a, broken, *args[2:], h_kind=h_kind)
        assert int(bad[1][0]) == 1 and bool(torch.isnan(bad[2][0]))
        assert all(torch.equal(u[1:], w[1:]) for u, w in zip(flat(bad), flat(one)))


def test_f0_grids_zero_iterations_and_refusals(dev):
    """maxit 0: x = 0, numit 0, an infinite residual and empty histories; the launches'
    refusals (A f64, bv f64, non-contiguous) and the shared ones (a table not (D,), a
    non-positive step or t) on CUDA tensors."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    a, bv, norms = grid_stack(dev, torch.float32, names=("housing_scale", "abalone"))
    lams = [10.0, 10.0]
    for core in ("mp", "adapdmp"):
        kernel, _, _ = _k7b(core)
        p2s = [1.0, 1.0] if core == "mp" else norms
        x, numit, nres, conv, lsf, hists = kernel(a, bv, lams, [1.0, 2.0], p2s, 0.0, 0,
                                                  record=True)
        assert numit.tolist() == [[0, 0]] * 2 and bool(torch.isinf(nres).all())
        assert not bool(conv.any()) and not bool(lsf.any()) and not bool(x.any())
        assert all(h.shape == (2, 2, 0) for h in hists)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernel(a.double(), bv, lams, K7A_TS, p2s, 0.0, 3)
        with pytest.raises(TypeError, match="float32 bv"):
            kernel(a, bv.double(), lams, K7A_TS, p2s, 0.0, 3)
        with pytest.raises(ValueError, match="contiguous"):
            kernel(a.transpose(1, 2).contiguous().transpose(1, 2), bv, lams, K7A_TS, p2s, 0.0, 3)
        with pytest.raises(ValueError, match="one value a dataset"):
            kernel(a, bv, [10.0], K7A_TS, p2s, 0.0, 3)
        with pytest.raises(ValueError, match="must be positive"):
            kernel(a, bv, lams, K7A_TS, [-p for p in p2s], 0.0, 3)
        with pytest.raises(ValueError, match="coupling t"):
            kernel(a, bv, lams, [0.0], p2s, 0.0, 3)
    steps = ([1 / na for na in norms], [0.99 / na for na in norms])
    x, numit, nres, conv, hists = tf.resident_cv_grid(a, bv, lams, *steps, 0.0, 0)
    assert numit.tolist() == [0, 0] and bool(torch.isinf(nres).all()) and not bool(x.any())
    assert all(h.shape == (2, 0) for h in hists)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tf.resident_cv_grid(a.double(), bv, lams, *steps, 0.0, 3)
    with pytest.raises(ValueError, match="every entry of sigmas must be positive"):
        tf.resident_cv_grid(a, bv, lams, steps[0], [0.0, 1.0], 0.0, 3)


@pytest.mark.parametrize("driver", ["square_root_lasso", "least_absolute_deviation"])
def test_f0_drivers_resident_grid_is_three_launches(dev, tmp_path, driver):
    """--resident-grid on housing_scale's and abalone's stand-ins: one K7c, one K7b MP and
    one K7b AdaPDM+ launch and no K7d or K7a launch; each file's 31 rows with JAX's names
    and keys, and JAX's meta rows (fast_path "resident-grid", grid_total_s, fast_methods)."""
    import importlib

    from adaprox_tpu_torch.experiments.square_root_lasso import T_VALUES
    from adaprox_tpu_torch.ops import resident_f0 as tf
    from adaprox_tpu_torch.utils.logging import read_jsonl

    kernels = (tf.resident_cv_grid, tf.resident_mpls_grid, tf.resident_adapdmp_grid,
               tf.resident_condat_vu, tf.resident_mpls_sweep, tf.resident_adapdmp_sweep)
    mod = importlib.import_module(f"adaprox_tpu_torch.experiments.{driver}")
    before = [k.launches for k in kernels]
    mod.main(["--resident-grid", "--datasets", "housing_scale,abalone", "--maxit", "300",
              "--device", "cuda", "--outdir", str(tmp_path), "--no-plot"])
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1, 0, 0, 0]
    fast = ["Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
    for name in ("housing_scale", "abalone"):
        rows = read_jsonl(tmp_path / f"{name}.jsonl")
        names = list(dict.fromkeys(r["method"] for r in rows if "norm_res" in r))
        assert names == (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in T_VALUES]
                         + [f"AdaPDM+ (t={t})" for t in T_VALUES])
        assert all(list(r) == ["method", "norm_res", "A_evals", "At_evals"] for r in rows
                   if "norm_res" in r)
        meta = rows[-2]
        assert list(meta) == ["wall_s", "fast_path", "grid_total_s", "fast_methods"]
        assert meta["fast_path"] == "resident-grid" and meta["fast_methods"] == fast
        assert list(meta["wall_s"]) == list(meta["grid_total_s"]) == fast


# -- K7a and K7b on thread-block clusters: the layouts the launcher picks ----------------------

# A cell runs on one cluster of C CTAs, C picked from the shape alone; each CTA holds its block
# of A's rows in shared memory where it fits and reads the rest from device memory. These
# cases reach each layout and hold it against the plain version over a short horizon (random
# problems of the family, so the calibrated horizon of the drivers' inputs is cut to
# K7_SHORT) or against the one-row launch bit for bit.
K7_SHORT = 20


def f0_random(dev, m, n, dtype, seed=0):
    """(a, bv, ||A||_F) of a random problem of the f = 0 family: A (m, n) Gaussian / sqrt(n)
    in ``dtype``, bv = A w + noise with a sparse w (f32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)) / n**0.5
    w = rng.standard_normal(n) * (rng.random(n) < 0.2)
    bv = a @ w + 0.1 * rng.standard_normal(m)
    a_t = torch.as_tensor(a, dtype=torch.float32, device=dev).to(dtype)
    return a_t, torch.as_tensor(bv, dtype=torch.float32, device=dev), float(
        a_t.float().norm())


def _held_to_plain(got, want, horizon):
    """Trial counts and ls_failed equal, and the gamma, sigma, norm_res and objective rows
    within K7A_RTOL, over ``horizon`` iterations."""
    assert torch.equal(got[4], want[4])
    assert torch.equal(got[5][3][..., :horizon], want[5][3][..., :horizon])
    for k in (0, 1, 2, 4):
        u, w = got[5][k][..., :horizon], want[5][k][..., :horizon]
        err = (u - w).abs().amax(-1) / w.abs().amax(-1)
        assert float(err.max()) <= K7A_RTOL, k


def _held_to_plain_while_trials_agree(got, want, horizon):
    """For each row, the gamma, sigma, norm_res and objective rows within K7A_RTOL over the
    iterations before the first (within ``horizon``) where the trial counts differ, which
    must not be the first iteration."""
    for r in range(got[5][3].shape[0]):
        differ = (got[5][3][r, :horizon] != want[5][3][r, :horizon]).nonzero()
        k0 = int(differ[0]) if differ.numel() else horizon
        assert k0 >= 1, r
        for k in (0, 1, 2, 4):
            u, w = got[5][k][r, :k0], want[5][k][r, :k0]
            assert float((u - w).abs().max()) <= K7A_RTOL * float(w.abs().max()), (r, k)


def _rows_are_one_row_launches(kernel, a, bv, lam, ts, p2, tol, maxit, out, h_kind):
    for j, t in enumerate(ts):
        row = kernel(a, bv, lam, [t], p2, tol, maxit, record=True, h_kind=h_kind)
        assert all(torch.equal(u[0], w[j]) for u, w in zip(_flat(row), _flat(out))), t


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7a_reversed_and_permuted_ts_give_the_rows_permuted(dev, core):
    """The cells run at once, each on whichever cluster takes it: a sweep over ``ts``
    reversed or permuted gives the same rows, permuted, bit for bit (housing_scale, the
    drivers' 15 couplings, tol 1e-5, l2 and l1)."""
    from adaprox_tpu_torch.experiments.square_root_lasso import T_VALUES

    kernel, _ = _k7a(core)
    a, bv, norm_a, _ = k7a_inputs(dev, "housing_scale", torch.float32)
    p2 = 1.0 if core == "mp" else norm_a
    perm = [7, 3, 14, 0, 11, 5, 1, 9, 13, 2, 6, 12, 4, 10, 8]
    for h_kind in ("l2", "l1"):
        base = kernel(a, bv, 10.0, T_VALUES, p2, 1e-5, 2000, record=True, h_kind=h_kind)
        for order in (list(range(14, -1, -1)), perm):
            out = kernel(a, bv, 10.0, [T_VALUES[k] for k in order], p2, 1e-5, 2000,
                         record=True, h_kind=h_kind)
            assert all(torch.equal(u, w[order]) for u, w in zip(_flat(out), _flat(base)))


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7b_more_cells_than_clusters(dev, core):
    """housing_scale and abalone stacked at 4224 x 128 and the drivers' 15 couplings: 30
    cells, more than the clusters that run at once, some stopping early at tol 1e-5 and the
    others running to maxit. Every cell equals its one-row K7a launch on its slice, bit for
    bit, and the grid with ``ts`` reversed gives the same cells reversed."""
    from adaprox_tpu_torch.experiments.square_root_lasso import T_VALUES
    from adaprox_tpu_torch.ops import resident_f0 as tf

    kernel, _, sweep = _k7b(core)
    a, bv, norms = grid_stack(dev, torch.float32, names=("housing_scale", "abalone"))
    p2s = [1.0, 1.0] if core == "mp" else norms
    cells = 2 * len(T_VALUES)
    assert tf.f0_grid_plan(a, core, cells)["clusters"] < cells
    out = kernel(a, bv, [10.0, 10.0], T_VALUES, p2s, 1e-5, 1500, record=True)
    stopped = out[1] < 1500
    assert bool(stopped.any()) and not bool(stopped.all())
    for d in range(2):
        for j, t in enumerate(T_VALUES):
            row = sweep(a[d], bv[d], 10.0, [t], p2s[d], 1e-5, 1500, record=True)
            assert all(torch.equal(u[0], w[d, j]) for u, w in zip(_flat(row), _flat(out)))
    rev = kernel(a, bv, [10.0, 10.0], T_VALUES[::-1], p2s, 1e-5, 1500, record=True)
    assert all(torch.equal(u, w.flip(1)) for u, w in zip(_flat(rev), _flat(out)))


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
@pytest.mark.parametrize("case", ["housing_scale", "cpusmall_scale", "16384x256"])
def test_k7a_layouts_whole_and_split(dev, core, case):
    """housing_scale (512 x 128 f32) fits whole in its cluster's shared memory;
    cpusmall_scale (8192 x 128 f32, 4 MiB) and a 16384 x 256 problem do not, and read the
    rows a CTA does not hold from device memory. Each is held to its plain version over
    K7_SHORT iterations and each row equals its one-row launch bit for bit."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    kernel, plain = _k7a(core)
    if case == "16384x256":
        a, bv, norm_a = f0_random(dev, 16384, 256, torch.float32, seed=3)
    else:
        a, bv, norm_a, _ = k7a_inputs(dev, case, torch.float32)
    plan = tf.f0_grid_plan(a, core, len(K7A_TS))
    assert plan["whole"] == (case == "housing_scale")
    assert plan["rows_held"] <= plan["rows_per_cta"] and plan["cluster"] in (1, 2, 4, 8)
    if not plan["whole"]:
        assert plan["rows_held"] < plan["rows_per_cta"] and plan["cluster"] == 8
    p2 = 1.0 if core == "mp" else norm_a
    for h_kind in ("l2", "l1"):
        args = (a, bv, 10.0, K7A_TS, p2, -1.0, K7_SHORT)
        got = kernel(*args, record=True, h_kind=h_kind)
        want = plain(*args, record=True, h_kind=h_kind)
        _held_to_plain(got, want, K7_SHORT)
        _rows_are_one_row_launches(kernel, *args, got, h_kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1001, 136), (100, 1000), (333, 201), (7, 3)])
@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7a_ragged_shapes(dev, core, m, n, dtype):
    """m not a multiple of the cluster size (1001 rows over 4 CTAs), n > 128, m < n, n odd
    (scalar loads), a matrix smaller than a cluster's rows: against the plain version while
    the trial counts agree within K7_SHORT iterations, and each row equal to its one-row
    launch bit for bit. These random problems sit near the linesearch's ties: on the CPU
    the plain version's AdaPDM+ trial counts in f32 parted from f64's at iteration 6-17 (l2,
    t 1; 100x1000, 333x201, 7x3) and at iteration 1 (7x3, bf16 A, t 100); MP's at 34 or
    later, so the comparison runs up to the first iteration where the counts differ."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    kernel, plain = _k7a(core)
    a, bv, norm_a = f0_random(dev, m, n, dtype, seed=m + n)
    plan = tf.f0_grid_plan(a, core, len(K7A_TS))
    assert plan["whole"] and plan["rows_per_cta"] * plan["cluster"] >= m
    if (m, n, dtype) == (1001, 136, torch.float32):
        assert m % plan["cluster"] != 0
    p2 = 1.0 if core == "mp" else norm_a
    for h_kind in ("l2", "l1"):
        args = (a, bv, 1.0, K7A_TS, p2, -1.0, K7_SHORT)
        got = kernel(*args, record=True, h_kind=h_kind)
        want = plain(*args, record=True, h_kind=h_kind)
        _held_to_plain_while_trials_agree(got, want, K7_SHORT)
        _rows_are_one_row_launches(kernel, *args, got, h_kind)


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
@pytest.mark.parametrize("m,n", [(64, 9000), (80000, 8)])
def test_k7a_vectors_in_device_memory(dev, core, m, n):
    """Where a CTA's shared memory cannot hold the n-vectors (n = 9000: x, v, A'y and the
    column partials, 252 KB) or its rows' vectors (80000 rows over 8 CTAs: y, A x, w and bv,
    240 KB), the launch keeps them in its scratch in device memory (the peers' column
    partials then read from there): against the plain version while the trial counts agree
    within K7_SHORT iterations, and each row equal to its one-row launch bit for bit."""
    from adaprox_tpu_torch.ops import resident_f0 as tf

    kernel, plain = _k7a(core)
    a, bv, norm_a = f0_random(dev, m, n, torch.float32, seed=m + n)
    plan = tf.f0_grid_plan(a, core, len(K7A_TS))
    assert plan["scratch_floats"] > 0 and not plan["whole"] and plan["vectors_in_smem"] == 0
    p2 = 1.0 if core == "mp" else norm_a
    for h_kind in ("l2", "l1"):
        args = (a, bv, 1.0, K7A_TS, p2, -1.0, K7_SHORT)
        got = kernel(*args, record=True, h_kind=h_kind)
        want = plain(*args, record=True, h_kind=h_kind)
        _held_to_plain_while_trials_agree(got, want, K7_SHORT)
        _rows_are_one_row_launches(kernel, *args, got, h_kind)


@pytest.mark.parametrize("core", ["mp", "adapdmp"])
def test_k7b_nan_in_one_dataset_leaves_the_others_alone(dev, core):
    """A NaN in the middle dataset's bv (abalone's, of cpusmall_scale, abalone and
    housing_scale at 8192 x 128) breaks that dataset's cells at their first iteration; the
    other datasets' cells keep the bits of the grid without the NaN."""
    kernel, _, _ = _k7b(core)
    a, bv, norms = grid_stack(dev, torch.float32,
                              names=("cpusmall_scale", "abalone", "housing_scale"))
    p2s = [1.0] * 3 if core == "mp" else norms
    bad_bv = bv.clone()
    bad_bv[1, 5] = float("nan")
    for h_kind in ("l2", "l1"):
        good, bad = (kernel(a, b, [10.0] * 3, K7A_TS, p2s, 1e-5, 300, record=True,
                            h_kind=h_kind) for b in (bv, bad_bv))
        assert bad[1][1].tolist() == [1] * len(K7A_TS) and bool(torch.isnan(bad[2][1]).all())
        for d in (0, 2):
            assert all(torch.equal(u[d], w[d]) for u, w in zip(_flat(bad), _flat(good)))


def test_k7a_check_fails_a_kernel_that_skips_a_row_block(dev, tmp_path, monkeypatch):
    """The plain comparison guards every CTA's share: a kernel built so that rank 1 of each
    cluster owns no rows (its block of A, y and A x skipped) fails it on housing_scale (a
    cluster of 2), where the kernel as built passes."""
    import shutil

    from adaprox_tpu_torch.ops import resident_f0 as tf

    src = tf.GRID_SOURCE.read_text()
    line = "  const int rows = static_cast<int>(left < g.rows_per ? left : g.rows_per);\n"
    assert src.count(line) == 1
    for header in tf.GRID_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, tmp_path / header.name)
    mutant = tmp_path / "resident_f0_grid_skip_rank1.cu"
    mutant.write_text(src.replace(line, line.replace(
        "static_cast<int>(left", "rank == 1 ? 0 : static_cast<int>(left")))
    a, bv, _, _ = k7a_inputs(dev, "housing_scale", torch.float32)
    assert tf.f0_grid_plan(a, "mp", len(K7A_TS))["cluster"] == 2
    args = (a, bv, 10.0, K7A_TS, 1.0, -1.0, K7_SHORT)
    want = tf.resident_mpls_sweep_plain(*args, record=True)
    _held_to_plain(tf.resident_mpls_sweep(*args, record=True), want, K7_SHORT)
    monkeypatch.setattr(tf, "GRID_SOURCE", mutant)
    got = tf.resident_mpls_sweep(*args, record=True)
    torch.cuda.synchronize()
    err = (got[5][2] - want[5][2]).abs().amax(-1) / want[5][2].abs().amax(-1)
    assert float(err.max()) > K7A_RTOL


# -- K5, the fused one-pass primal-dual update ---------------------------------------------------

# K5 against its plain version: f32 FMAs in another summation order than cuBLAS's gemv, so
# each output is held to 1e-5 of its largest magnitude, as K1 is (the prox is 1-Lipschitz in
# v, so x_new inherits v's rounding; A x_new sums over n rows of A').
K5_RTOL = 1e-5
K5_MENU = [("l1", 0.7, 0.0), ("box", -0.5, 0.5), ("elastic", 0.3, 0.2), ("zero", 0.0, 0.0)]


def _k5_inputs(dev, n, m, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    at = (torch.randn(n, m, generator=gen, device=dev) / m**0.5).to(dtype)
    y, x, grad = (torch.randn(k, generator=gen, device=dev) for k in (m, n, n))
    return at, y, x, grad


def _k5_err(got, want):
    return max(float((u - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for u, w in zip(got, want))


@pytest.mark.parametrize("n,m", [(16, 8192), (16, 4224), (16, 512), (64, 1024), (256, 777),
                                 (48, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,p1,p2", K5_MENU)
def test_k5_matches_plain_on_card(dev, n, m, dtype, kind, p1, p2):
    """The drivers' padded A' (16 x 8192, 16 x 4224, 16 x 512), an aligned 64 x 1024 and
    ragged m (777, 1): every output within K5_RTOL of its largest magnitude."""
    at, y, x, grad = _k5_inputs(dev, n, m, dtype)
    gamma = torch.tensor(0.37, device=dev)
    from adaprox_tpu_torch.ops import pd_kernels as tp

    got = tp.fused_pd_primal_update(at, y, x, grad, gamma, p1, p2, prox_kind=kind)
    want = tp.pd_primal_update_plain(at, y, x, grad, gamma, p1, p2, prox_kind=kind)
    torch.cuda.synchronize()
    assert [t.shape for t in got] == [(n,), (n,), (n,), (m,)]
    assert all(t.dtype == torch.float32 and t.device == at.device for t in got)
    assert _k5_err(got, want) <= K5_RTOL


def test_k5_is_repeatable_and_counts_its_launches(dev):
    """No atomics: two launches give the same bits; each launch adds one to the counter
    and a CPU call (the plain version) adds none; gamma as a number or on the card is the
    same."""
    from adaprox_tpu_torch.ops import pd_kernels as tp

    at, y, x, grad = _k5_inputs(dev, 4096, 4096, torch.float32, seed=3)
    before = tp.fused_pd_primal_update.launches
    one = tp.fused_pd_primal_update(at, y, x, grad, torch.tensor(0.01, device=dev), 0.2)
    two = tp.fused_pd_primal_update(at, y, x, grad, 0.01, 0.2)
    assert all(torch.equal(u, w) for u, w in zip(one, two))
    assert tp.fused_pd_primal_update.launches == before + 2
    tp.fused_pd_primal_update(at.cpu(), y.cpu(), x.cpu(), grad.cpu(), 0.01, 0.2)
    assert tp.fused_pd_primal_update.launches == before + 2


@pytest.mark.parametrize("kind,p1,p2", K5_MENU)
def test_k5_keeps_nan_semantics(dev, kind, p1, p2):
    """jnp's NaN semantics in the prox: a NaN in x gives NaN at its x_new (sign, maximum
    and clip propagate it) and NaN in every entry of A x_new, as the plain version does;
    a zero v gives an exact zero (sign(0) = 0)."""
    from adaprox_tpu_torch.ops import pd_kernels as tp

    at, y, x, grad = _k5_inputs(dev, 32, 256, torch.float32, seed=4)
    x[5] = float("nan")
    y[:], grad[7], x[7] = 0.0, 0.0, 0.0
    got = tp.fused_pd_primal_update(at, y, x, grad, 0.5, p1, p2, prox_kind=kind)
    want = tp.pd_primal_update_plain(at, y, x, grad, 0.5, p1, p2, prox_kind=kind)
    for u, w in zip(got, want):
        assert torch.equal(torch.isnan(u), torch.isnan(w))
    assert bool(torch.isnan(got[2][5])) and bool(torch.isnan(got[3]).all())
    assert float(got[2][7]) == 0.0 and not bool(torch.isnan(got[0]).any())


def test_k5_refuses_what_it_does_not_take(dev):
    from adaprox_tpu_torch.ops import pd_kernels as tp

    at, y, x, grad = _k5_inputs(dev, 16, 256, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tp.fused_pd_primal_update(at.double(), y, x, grad, 0.1)
    with pytest.raises(TypeError, match="float32 y, x and grad"):
        tp.fused_pd_primal_update(at, y.double(), x, grad, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tp.fused_pd_primal_update(at.t().contiguous().t(), y, x, grad, 0.1)
    with pytest.raises(TypeError, match="gamma"):
        tp.fused_pd_primal_update(at, y, x, grad, torch.tensor(0.1))
    with pytest.raises(ValueError, match="not divisible"):
        tp.fused_pd_primal_update(at[:12].contiguous(), y, x[:12], grad[:12], 0.1)
    with pytest.raises(ValueError, match="not divisible"):  # bf16 rows come in 16s
        tp.fused_pd_primal_update(torch.zeros(8, 256, dtype=torch.bfloat16, device=dev), y,
                                  x[:8], grad[:8], 0.1)


def _all_launch_counts():
    from adaprox_tpu_torch.ops import resident_f0, resident_mp, resident_pd

    return [f.launches for f in (
        tk.fused_ls_value_grad, tk.fused_logistic_value_grad, tr.resident_adapgm,
        tr.resident_rule_sweep, trb.resident_backtracking, trb.resident_bt_sweep,
        trb.resident_agraal, resident_pd.resident_adapdm_dsvm,
        resident_pd.resident_adapdm_dsvm_sweep, resident_pd.resident_cv_dsvm,
        resident_mp.resident_mp_dsvm_sweep, resident_f0.resident_condat_vu,
        resident_f0.resident_mpls_sweep, resident_f0.resident_adapdmp_sweep,
        resident_f0.resident_mpls_grid, resident_f0.resident_adapdmp_grid,
        resident_f0.resident_cv_grid)]


@pytest.mark.parametrize("inner", ["l2", "l1"])
def test_fused_condat_vu_launches_k5_and_nothing_else(dev, inner):
    """fused_condat_vu on housing_scale's stand-in in f32 on the card: exactly 1 + numit
    K5 launches (the warm-up and one an iteration) and no other kernel; its objective
    within 1e-4 of the engine's condat_vu on the card (the same iteration in another
    summation order), both run to maxit 300 at tol 0, and the engine's counters but the
    one A x ahead."""
    import numpy as np

    import adaprox_tpu_torch as apt
    from adaprox_tpu_torch.ops import pd_kernels as tp
    from adaprox_tpu_torch.utils.datasets import load_or_synthesize

    x_np, y_np, _ = load_or_synthesize("housing_scale")
    f, g, h, a_op, norm_a = apt.sqrt_lasso_from_numpy(x_np, y_np, 10.0, inner, device=dev,
                                                      dtype=torch.float32)
    m, n = a_op.shape
    x0, y0 = torch.zeros(n, device=dev), torch.zeros(m, device=dev)
    others, before = _all_launch_counts(), tp.fused_pd_primal_update.launches
    res = apt.fused_condat_vu(x0, y0, f=f, g=g, h=h, A=a_op.a, at=a_op.a.t().contiguous(),
                              Lf=0.0, norm_A=norm_a, tol=0.0, maxit=300)
    torch.cuda.synchronize()
    assert tp.fused_pd_primal_update.launches - before == 1 + res.numit == 301
    assert _all_launch_counts() == others
    ref = apt.condat_vu(x0, y0, f=f, g=g, h=h, A=a_op, Lf=0.0, norm_A=norm_a, tol=0.0,
                        maxit=300)
    obj = float(g(res.x) + h(a_op.matvec(res.x)))
    obj_ref = float(g(ref.x) + h(a_op.matvec(ref.x)))
    assert res.x.shape == (n,) and res.y.shape == (m,) and np.isfinite(obj)
    assert abs(obj - obj_ref) <= 1e-4 * abs(obj_ref)
    # unconverged, the fused pass has made the next iteration's A x already
    assert res.counters._replace(A_evals=res.counters.A_evals - 1) == ref.counters


@pytest.mark.parametrize("driver", ["square_root_lasso", "least_absolute_deviation"])
def test_f0_drivers_fused_is_one_k5_pass_an_iteration(dev, tmp_path, driver):
    """--fused on housing_scale's stand-in at --maxit 300: the Condat-Vu row on K5 (1 + its
    iterations launches), no whole-solve kernel, the 31 rows with JAX's names and keys, and
    JAX's meta row (fast_path "fused", fast_methods ["Condat-Vu"])."""
    import importlib

    from adaprox_tpu_torch.experiments.square_root_lasso import T_VALUES
    from adaprox_tpu_torch.ops import pd_kernels as tp
    from adaprox_tpu_torch.utils.logging import read_jsonl

    mod = importlib.import_module(f"adaprox_tpu_torch.experiments.{driver}")
    others, before = _all_launch_counts(), tp.fused_pd_primal_update.launches
    mod.main(["--fused", "--datasets", "housing_scale", "--maxit", "300", "--device", "cuda",
              "--outdir", str(tmp_path), "--no-plot"])
    rows = read_jsonl(tmp_path / "housing_scale.jsonl")
    cv = [r for r in rows if r.get("method") == "Condat-Vu"]
    assert tp.fused_pd_primal_update.launches - before == 1 + len(cv)
    assert _all_launch_counts() == others
    assert (cv[0]["A_evals"], cv[0]["At_evals"]) == (2, 1)
    names = list(dict.fromkeys(r["method"] for r in rows if "norm_res" in r))
    assert names == (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in T_VALUES]
                     + [f"AdaPDM+ (t={t})" for t in T_VALUES])
    assert all(list(r) == ["method", "norm_res", "A_evals", "At_evals"] for r in rows
               if "norm_res" in r)
    assert rows[-2]["fast_path"] == "fused" and rows[-2]["fast_methods"] == ["Condat-Vu"]


# -- K8, K9a, K9b: the sparse matvecs -------------------------------------------------------

# f32 sums in another order than the plain version's: at most SPARSE_RTOL of the largest
# sum of |a_ij x_j| of a row (the products' magnitude), as chip_smoke.py holds them
SPARSE_RTOL = 1e-5


def _sparse_err(got, want, scale):
    return float((got - want).abs().max()) / max(float(scale), 1e-30)


def _ell_inputs(dev, m, k, n, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vals = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    cols = torch.randint(0, n, (m, k), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn(n, generator=gen, device=dev)
    return vals, cols, x


@pytest.mark.parametrize("m,k,n", [(8, 128, 40), (1024, 256, 3000), (4096, 1280, 8192),
                                   (16, 130, 50), (64, 4, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_matches_plain_on_card(dev, m, k, n, dtype):
    """K8 against ell_matvec_plain on the same tensors: vector loads (k % 4 == 0) and
    scalar ones (k 130), f32 and bf16 vals; one launch counted."""
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x = _ell_inputs(dev, m, k, n, dtype)
    before = ts.ell_matvec.launches
    got = ts.ell_matvec(vals, cols, x)
    torch.cuda.synchronize()
    assert ts.ell_matvec.launches == before + 1
    want = ts.ell_matvec_plain(vals, cols, x, m)
    scale = ts.ell_matvec_plain(vals.float().abs(), cols, x.abs(), m).max()
    assert got.shape == (m,) and got.dtype == torch.float32
    assert _sparse_err(got, want, scale) <= SPARSE_RTOL


def test_k8_is_repeatable_and_keeps_nan_semantics(dev):
    """No atomics: two launches give the same bits. The padding entries (val 0, col 0)
    are not skipped: a NaN x[0] reaches every row that has one, as jnp's sum does."""
    from adaprox_tpu_torch.ops import sparse as ts

    d = torch.randn(64, 300, device=dev) * (torch.rand(64, 300, device=dev) < 0.1)
    op = ts.ELLOperator.from_dense(d)
    x = torch.randn(300, device=dev)
    assert torch.equal(ts.ell_matvec(op.vals, op.cols, x), ts.ell_matvec(op.vals, op.cols, x))
    x[0] = float("nan")
    got = ts.ell_matvec(op.vals, op.cols, x)
    want = ts.ell_matvec_plain(op.vals, op.cols, x, op.vals.shape[0])
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(got).all())


def test_k8_refuses_what_it_does_not_take(dev):
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x = _ell_inputs(dev, 16, 128, 40, torch.float32)
    with pytest.raises(ValueError, match="m % 8"):
        ts.ell_matvec(vals[:12].contiguous(), cols[:12].contiguous(), x)
    with pytest.raises(TypeError, match="float32 x"):
        ts.ell_matvec(vals, cols, x.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ts.ell_matvec(vals.double(), cols, x)
    with pytest.raises(TypeError, match="int32"):
        ts.ell_matvec(vals, cols.long(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ts.ell_matvec(vals.t().contiguous().t(), cols, x)


# row extents of the ragged case: empty, one entry, not multiples of the vector width, k-1, k
RAGGED = (0, 1, 3, 5, -1, None)


def _ragged_ell(dev, k, dtype, n=300, seed=3, tiles=8):
    """6 * tiles rows cycling through the RAGGED extents (-1: k - 1, None: k); each row's
    held entries random at columns 1..n-1, (val 0, col 0) after them. Returns vals, cols,
    x and the exact extents (int32)."""
    lens = [k - 1 if e == -1 else k if e is None else e for e in RAGGED] * tiles
    vals, cols, x = _ell_inputs(dev, len(lens), k, n, dtype, seed)
    cols = cols % (n - 1) + 1
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    held = torch.arange(k, device=dev)[None, :] < ln[:, None]
    vals = torch.where(held, vals, torch.zeros((), dtype=dtype, device=dev)).contiguous()
    cols = torch.where(held, cols, torch.zeros((), dtype=cols.dtype, device=dev)).contiguous()
    return vals, cols, x, ln


@pytest.mark.parametrize("k", [130, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_with_lengths_matches_plain_on_card(dev, dtype, k):
    """K8 reading each row's first lengths[i] entries (0, 1, 3, 5, k - 1, k) against the
    plain padded sum: k 130 takes the scalar path, k 1280 the vector one (with a scalar
    end where a length is not a multiple of 4) and whole unrolled steps; one launch
    counted; the operator built from the same arrays counts the same extents."""
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x, ln = _ragged_ell(dev, k, dtype)
    m = vals.shape[0]
    before = ts.ell_matvec.launches
    got = ts.ell_matvec(vals, cols, x, ln)
    torch.cuda.synchronize()
    assert ts.ell_matvec.launches == before + 1
    want = ts.ell_matvec_plain(vals, cols, x, m)
    scale = ts.ell_matvec_plain(vals.float().abs(), cols, x.abs(), m).max()
    assert got.shape == (m,) and got.dtype == torch.float32
    assert _sparse_err(got, want, scale) <= SPARSE_RTOL
    counted = ts.held_lengths(vals.cpu(), cols.cpu())
    assert torch.equal(counted, torch.clamp((ln.cpu() + 3) // 4 * 4, max=k).int())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_k8_with_lengths_keeps_the_nan_pattern_on_card(dev, bad):
    """A NaN or inf x[0] reaches exactly the rows the plain padded sum sends it to: every
    row with padding (lengths[i] < k) turns NaN, the full rows (no column 0 among their
    entries) stay finite; so through the operator too, both ways."""
    from adaprox_tpu_torch.ops import sparse as ts

    for k in (130, 1280):
        vals, cols, x, ln = _ragged_ell(dev, k, torch.float32)
        x[0] = bad
        got = ts.ell_matvec(vals, cols, x, ln)
        want = ts.ell_matvec_plain(vals, cols, x, vals.shape[0])
        padded = (ln < k).cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(got).cpu()[padded].all())
        assert bool(torch.isfinite(got).cpu()[~padded].all())
    d = torch.randn(64, 300, device=dev) * (torch.rand(64, 300, device=dev) < 0.1)
    op = ts.ELLOperator.from_dense(d)
    for fn, v, c, n in (("matvec", op.vals, op.cols, 300), ("rmatvec", op.vals_t, op.rows_t, 64)):
        u = torch.randn(n, device=dev)
        u[0] = bad
        got = getattr(op, fn)(u)
        want = ts.ell_matvec_plain(v, c, u, v.shape[0])[: got.shape[0]]
        assert torch.equal(torch.isnan(got), torch.isnan(want))


def test_k8_lengths_none_is_full_lengths_and_repeatable(dev):
    """lengths None reads every row's k entries: the same bits as lengths = k every row;
    two launches with the operator's extents give the same bits, as do two without."""
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x = _ell_inputs(dev, 1024, 1280, 3000, torch.float32, seed=4)
    full = torch.full((1024,), 1280, dtype=torch.int32, device=dev)
    bare = ts.ell_matvec(vals, cols, x)
    assert torch.equal(bare, ts.ell_matvec(vals, cols, x, full))
    assert torch.equal(bare, ts.ell_matvec(vals, cols, x))
    d = torch.randn(512, 2048, device=dev) * (torch.rand(512, 2048, device=dev) < 0.05)
    op = ts.ELLOperator.from_dense(d)
    x = torch.randn(2048, device=dev)
    once = ts.ell_matvec(op.vals, op.cols, x, op.row_len)
    assert torch.equal(once, ts.ell_matvec(op.vals, op.cols, x, op.row_len))


@pytest.mark.parametrize("k", [130, 1280])
def test_k8_check_fails_a_kernel_that_drops_a_held_entry(dev, k):
    """The plain comparison catches a K8 that stops one entry short: the same call with
    one row's extent shortened by one leaves the plain padded sum by more than the
    tolerance, where the exact extents pass."""
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x, ln = _ragged_ell(dev, k, torch.float32)
    m = vals.shape[0]
    row = 4  # extent k - 1: its last held entry is at k - 2
    vals[row, k - 2], cols[row, k - 2], x[7] = 1.0, 7, 2.0
    want = ts.ell_matvec_plain(vals, cols, x, m)
    scale = ts.ell_matvec_plain(vals.abs(), cols, x.abs(), m).max()
    assert _sparse_err(ts.ell_matvec(vals, cols, x, ln), want, scale) <= SPARSE_RTOL
    short = ln.clone()
    short[row] -= 1
    assert _sparse_err(ts.ell_matvec(vals, cols, x, short), want, scale) > SPARSE_RTOL


@pytest.mark.parametrize("x0", [0.5, float("nan"), float("inf")])
@pytest.mark.parametrize("k", [130, 1280])
@pytest.mark.parametrize("rows_per_cta", ["many", "most"])
def test_k8_takes_many_rows_a_cta_on_card(dev, rows_per_cta, k, x0):
    """K8's grid holds at most 8 CTAs an SM, so past 8 x SMs rows a CTA takes several
    (the chunk deal carries on from row to row), and past 64 times that the grid grows
    so that a CTA takes at most 64. "many": 16 x 8 x SMs + 8 rows (17 a CTA or more);
    "most": 64 x 8 x SMs + 2048 rows (the grid past its resident size, 64 a CTA). The
    RAGGED extents tiled over every row (empty rows, scalar ends, k - 1, k), x[0] finite,
    NaN or inf, against the plain padded sum: NaN in exactly the plain version's rows,
    which are the padded rows where x[0] is not finite; the rest within SPARSE_RTOL and
    the same bits twice."""
    from adaprox_tpu_torch.ops import sparse as ts

    resident = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    m = 16 * resident + 8 if rows_per_cta == "many" else 64 * resident + 2048
    vals, cols, x, ln = _ragged_ell(dev, k, torch.float32, n=5000, seed=5,
                                    tiles=-(-m // len(RAGGED)))
    vals, cols, ln = vals[:m].contiguous(), cols[:m].contiguous(), ln[:m].contiguous()
    x[0] = x0
    got = ts.ell_matvec(vals, cols, x, ln)
    want = ts.ell_matvec_plain(vals, cols, x, m)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(nan, (ln < k) if not math.isfinite(x0) else torch.zeros_like(nan))
    scale = ts.ell_matvec_plain(vals.abs(), cols, x.abs(), m)[~nan].max()
    assert _sparse_err(got[~nan], want[~nan], scale) <= SPARSE_RTOL
    assert torch.equal(got[~nan], ts.ell_matvec(vals, cols, x, ln)[~nan])


def test_k8_refuses_lengths_it_does_not_take(dev):
    from adaprox_tpu_torch.ops import sparse as ts

    vals, cols, x = _ell_inputs(dev, 16, 128, 40, torch.float32)
    ln = torch.full((16,), 128, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="lengths must be int32"):
        ts.ell_matvec(vals, cols, x, ln.long())
    with pytest.raises(ValueError, match="lengths must be"):
        ts.ell_matvec(vals, cols, x, ln[:8])
    with pytest.raises(ValueError, match="lengths must be"):
        ts.ell_matvec(vals, cols, x, ln.cpu())
    with pytest.raises(ValueError, match="and contiguous; got .* contiguous False"):
        ts.ell_matvec(vals, cols, x, torch.full((16, 2), 128, dtype=torch.int32,
                                                device=dev)[:, 0])


def test_k8_cold_rates_at_the_sparse_case_within_the_card(dev):
    """At the slice's case (8192 x 16384 f32, 10% of the (64, 512) tiles), K8 both ways:
    the L2-flushed rate over the bytes the rows hold (their extents
    times 8 bytes, the extents, x and y) is at or under the card's data-sheet rate, and
    each result agrees with the plain padded sum."""
    from adaprox_tpu_torch.experiments.sparse_calibration import sparse_case
    from adaprox_tpu_torch.ops import sparse as ts

    roof = chip_bandwidth_gbps(dev)
    assert math.isfinite(roof), f"no data-sheet rate for {torch.cuda.get_device_name(dev)}"
    d = sparse_case()
    op = ts.ELLOperator.from_dense(d, device=dev)
    m, n = d.shape
    del d
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    gbps = {}
    for way, (v, c, ln, u) in {
            "A x": (op.vals, op.cols, op.row_len, torch.randn(n, generator=gen, device=dev)),
            "A'y": (op.vals_t, op.rows_t, op.row_len_t,
                    torch.randn(m, generator=gen, device=dev))}.items():
        want = ts.ell_matvec_plain(v, c, u, v.shape[0])
        scale = ts.ell_matvec_plain(v.abs(), c, u.abs(), v.shape[0]).max()
        moved = (int(ln.sum()) * (v.element_size() + 4) + 4 * ln.numel() + 4 * u.numel()
                 + 4 * v.shape[0])

        def kernel():
            return ts.ell_matvec(v, c, u, ln)

        assert _sparse_err(kernel(), want, scale) <= SPARSE_RTOL, way
        gbps[way] = moved / flushed_ms(kernel) / 1e6
    print(f"K8 cold GB/s over the held bytes at the sparse case against {roof:g}: {gbps}")
    assert all(v <= roof for v in gbps.values()), gbps


def _bcsr_case(dev, m, n, block, density, seed=0):
    """A (block)-tiled matrix on the card with an empty and a trailing empty block row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bm, bn = block
    mask = torch.rand(-(-m // bm), -(-n // bn), generator=gen, device=dev) < density
    mask[1, :] = False
    mask[-1, :] = False
    d = torch.randn(mask.shape[0] * bm, mask.shape[1] * bn, generator=gen, device=dev)
    d = (d * mask.repeat_interleave(bm, 0).repeat_interleave(bn, 1))[:m, :n]
    return d


@pytest.mark.parametrize("m,n,block", [(64, 512, (8, 128)), (1024, 4096, (64, 512)),
                                       (200, 1000, (16, 100)), (48, 390, (8, 130))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_match_plain_and_each_other_on_card(dev, m, n, block, dtype):
    """K9a and K9b (slab 4 and 8) against bcsr_matvec_plain, both directions; K9b equals
    K9a bit for bit on finite input (the same row routine, summed in the same order);
    each launch counted."""
    from adaprox_tpu_torch.ops import bcsr as tb

    d = _bcsr_case(dev, m, n, block, 0.3)
    op = tb.BCSROperator.from_dense(d, block, dtype=dtype)
    for vals, cols, rowptr, rows, max_bpr, size in (
            (op.vals, op.cols, op.rowptr, op.rows, op.max_bpr, op.padded_shape[1]),
            (op.vals_t, op.cols_t, op.rowptr_t, op.rows_t, op.max_bpr_t, op.padded_shape[0])):
        x = torch.randn(-(-size // block[1]) * block[1], device=dev)
        nbr = rowptr.shape[0] - 1
        want = tb.bcsr_matvec_plain(vals, cols, rows, x, nbr, rowptr=rowptr)
        scale = tb.bcsr_matvec_plain(vals.float().abs(), cols, rows, x.abs(), nbr).max()
        before = (tb.bcsr_matvec.launches, tb.bcsr_matvec_slab.launches)
        k9a = tb.bcsr_matvec(vals, cols, rowptr, max_bpr, x)
        slabs = [tb.bcsr_matvec_slab(vals, cols, rows, nbr, x, slab=s) for s in (4, 8)]
        torch.cuda.synchronize()
        assert (tb.bcsr_matvec.launches, tb.bcsr_matvec_slab.launches) == (before[0] + 1,
                                                                            before[1] + 2)
        assert k9a.shape == (nbr * vals.shape[1],) and k9a.dtype == torch.float32
        assert _sparse_err(k9a, want, scale) <= SPARSE_RTOL
        assert all(torch.equal(s, k9a) for s in slabs)


def test_k9_repeatable_and_slab_padding_nan(dev):
    """Two launches give the same bits; a NaN in column block 0 reaches block row 0
    through K9b's zero padding tiles (as the JAX slab kernel's), not through K9a."""
    from adaprox_tpu_torch.ops import bcsr as tb

    d = _bcsr_case(dev, 64, 512, (8, 128), 0.4, seed=3)
    d[:8, :128] = 0.0
    d[:8, 128:256] = 1.0  # block row 0 holds a tile, not in column block 0
    op = tb.BCSROperator.from_dense(d, (8, 128))
    nnzb = op.vals.shape[0]
    slab = next(s for s in (3, 5, 7, 9) if nnzb % s)
    x = torch.randn(512, device=dev)
    k9a = tb.bcsr_matvec(op.vals, op.cols, op.rowptr, op.max_bpr, x)
    assert torch.equal(k9a, tb.bcsr_matvec(op.vals, op.cols, op.rowptr, op.max_bpr, x))
    k9b = tb.bcsr_matvec_slab(op.vals, op.cols, op.rows, 8, x, slab=slab)
    assert torch.equal(k9b, tb.bcsr_matvec_slab(op.vals, op.cols, op.rows, 8, x, slab=slab))
    x[0] = float("nan")
    k9a = tb.bcsr_matvec(op.vals, op.cols, op.rowptr, op.max_bpr, x)
    k9b = tb.bcsr_matvec_slab(op.vals, op.cols, op.rows, 8, x, slab=slab)
    want = tb.bcsr_matvec_slab(op.vals.cpu(), op.cols.cpu(), op.rows.cpu(), 8, x.cpu(),
                               slab=slab)
    assert torch.equal(torch.isnan(k9b).cpu(), torch.isnan(want))
    assert bool(torch.isnan(k9b[:8]).all()) and bool(torch.isfinite(k9a[:8]).all())


def test_k9_refuses_what_it_does_not_take(dev):
    from adaprox_tpu_torch.ops import bcsr as tb

    op = tb.BCSROperator.from_dense(_bcsr_case(dev, 64, 512, (8, 128), 0.4), (8, 128))
    x = torch.randn(512, device=dev)
    with pytest.raises(TypeError, match="float32 x"):
        tb.bcsr_matvec(op.vals, op.cols, op.rowptr, op.max_bpr, x.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tb.bcsr_matvec_slab(op.vals.double(), op.cols, op.rows, 8, x)
    with pytest.raises(TypeError, match="int32"):
        tb.bcsr_matvec(op.vals, op.cols.long(), op.rowptr, op.max_bpr, x)
    with pytest.raises(ValueError, match="whole blocks"):
        tb.bcsr_matvec(op.vals, op.cols, op.rowptr, op.max_bpr, x[:500])
    with pytest.raises(ValueError, match="contiguous"):
        tb.bcsr_matvec(op.vals.transpose(1, 2).contiguous().transpose(1, 2), op.cols,
                       op.rowptr, op.max_bpr, x)


@pytest.mark.parametrize("m,n,block", [(64, 512, (8, 128)), (1024, 4096, (64, 512)),
                                       (200, 1000, (16, 100)), (48, 390, (8, 130))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_rmatvec_match_plain_and_each_other_on_card(dev, m, n, block, dtype):
    """K9a's and K9b's A'y over A's own tiles against bcsr_rmatvec_plain (SPARSE_RTOL of
    the largest |a||y| column sum); K9b equals K9a bit for bit, two launches give the same
    bits, and each launch adds one to its kernel's count (the A x counts); the operator's
    "pallas" and "slab" rmatvec are these launches."""
    from adaprox_tpu_torch.ops import bcsr as tb

    d = _bcsr_case(dev, m, n, block, 0.3)
    op = tb.BCSROperator.from_dense(d, block, dtype=dtype)
    args = (op.vals, op.rows, op.colptr, op.col_tiles, op.colptr.shape[0] - 1)
    y = torch.randn(op.padded_shape[0], device=dev)
    want = tb.bcsr_rmatvec_plain(*args[:4], y, args[4])
    scale = tb.bcsr_rmatvec_plain(op.vals.float().abs(), *args[1:4], y.abs(), args[4]).max()
    before = (tb.bcsr_matvec.launches, tb.bcsr_matvec_slab.launches)
    k9a, k9a_again = tb.bcsr_rmatvec(*args, y), tb.bcsr_rmatvec(*args, y)
    k9b, k9b_again = tb.bcsr_rmatvec_slab(*args, y), tb.bcsr_rmatvec_slab(*args, y)
    torch.cuda.synchronize()
    assert (tb.bcsr_matvec.launches, tb.bcsr_matvec_slab.launches) == (before[0] + 2,
                                                                        before[1] + 2)
    assert k9a.shape == (op.padded_shape[1],) and k9a.dtype == torch.float32
    assert _sparse_err(k9a, want, scale) <= SPARSE_RTOL
    assert torch.equal(k9a, k9a_again) and torch.equal(k9b, k9b_again) and torch.equal(k9b, k9a)
    for route, got in (("pallas", k9a), ("slab", k9b)):
        assert torch.equal(tb.BCSROperator.from_dense(d, block, route, dtype=dtype).rmatvec(
            y[:m]), got[:n])


def test_k9_rmatvec_non_finite_y_on_card(dev):
    """A NaN in y reaches, on both kernels as in their plain version, every output of each
    block column that has a tile in its block row, and no other."""
    from adaprox_tpu_torch.ops import bcsr as tb

    op = tb.BCSROperator.from_dense(_bcsr_case(dev, 64, 512, (8, 128), 0.4, seed=3), (8, 128))
    args = (op.vals, op.rows, op.colptr, op.col_tiles, op.colptr.shape[0] - 1)
    y = torch.randn(64, device=dev)
    y[20] = float("nan")
    want = torch.isnan(tb.bcsr_rmatvec_plain(*args[:4], y, args[4]))
    assert bool(want.any()) and not bool(want.all())
    for fn in (tb.bcsr_rmatvec, tb.bcsr_rmatvec_slab):
        assert torch.equal(torch.isnan(fn(*args, y)), want)


def test_k9_rmatvec_refuses_what_it_does_not_take(dev):
    from adaprox_tpu_torch.ops import bcsr as tb

    op = tb.BCSROperator.from_dense(_bcsr_case(dev, 64, 512, (8, 128), 0.4), (8, 128))
    args = [op.vals, op.rows, op.colptr, op.col_tiles, op.colptr.shape[0] - 1]
    y = torch.randn(64, device=dev)
    for fn in (tb.bcsr_rmatvec, tb.bcsr_rmatvec_slab):
        with pytest.raises(TypeError, match="float32 y"):
            fn(*args, y.double())
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(op.vals.double(), *args[1:], y)
        with pytest.raises(TypeError, match="int32"):
            fn(op.vals, op.rows.long(), *args[2:], y)
        with pytest.raises(ValueError, match="whole blocks"):
            fn(*args, y[:60])
        with pytest.raises(ValueError, match="different devices"):
            fn(*args, y.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(op.vals.transpose(1, 2).contiguous().transpose(1, 2), *args[1:], y)
    # K9b's first pass over A x streams vals by bulk copies: 16-byte alignment or a refusal
    shifted = torch.empty(op.vals.numel() + 1, device=dev)[1:].view(op.vals.shape)
    shifted.copy_(op.vals)
    x = torch.randn(512, device=dev)
    with pytest.raises(ValueError, match="bulk copies"):
        tb.bcsr_matvec_slab(shifted, op.cols, op.rows, 8, x)
    scale = tb.bcsr_matvec_plain(op.vals.abs(), op.cols, op.rows, x.abs(), 8).max()
    assert _sparse_err(tb.bcsr_matvec(shifted, op.cols, op.rowptr, op.max_bpr, x),
                       tb.bcsr_matvec_plain(op.vals, op.cols, op.rows, x, 8),
                       scale) <= SPARSE_RTOL  # K9a takes scalar loads there


@pytest.mark.parametrize("kernel", ["K9a", "K9b"])
def test_k9_rmatvec_check_fails_a_kernel_that_skips_a_tile(dev, tmp_path, kernel):
    """The plain comparison is a guard of the byte count, not only the rate cap: a kernel
    built to skip the last tile of each block column (K9a's column loop, or K9b's second
    pass) fails it, where the kernel as built passes."""
    from adaprox_tpu_torch.ops import bcsr as tb

    src = tb.SOURCE.read_text()
    line = {"K9a": "  const int col_end = colptr[c + 1];\n",
            "K9b": "  const int k_end = colptr[c + 1];\n"}[kernel]
    assert src.count(line) == 1
    mutant, so = tmp_path / "bcsr_matvec.cu", tmp_path / f"bcsr_skip_{kernel}.so"
    mutant.write_text(src.replace(line, line.replace("];", "] - 1;")))
    subprocess.run([tk._nvcc(), *tb.NVCC_FLAGS, "-I", str(tb.SOURCE.parent), "-o", str(so),
                    str(mutant)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adaprox_bcsr_rmatvec.argtypes = [p, i, i, p, p, p, p, ll, i, i, p, p]
    lib.adaprox_bcsr_rmatvec_slab.argtypes = [p, i, i, p, p, p, ll, p, ll, i, i, p, p, p]

    op = tb.BCSROperator.from_dense(_bcsr_case(dev, 1024, 4096, (64, 512), 0.3, seed=7))
    nnzb, bm, bn = op.vals.shape
    nbc = op.colptr.shape[0] - 1
    args = (op.vals, op.rows, op.colptr, op.col_tiles, nbc)
    y = torch.randn(op.padded_shape[0], device=dev)
    want = tb.bcsr_rmatvec_plain(*args[:4], y, nbc)
    scale = tb.bcsr_rmatvec_plain(op.vals.abs(), *args[1:4], y.abs(), nbc).max()
    good = {"K9a": tb.bcsr_rmatvec, "K9b": tb.bcsr_rmatvec_slab}[kernel](*args, y)
    assert _sparse_err(good, want, scale) <= SPARSE_RTOL
    out = torch.empty(nbc * bn, device=dev)
    ptrs = (op.vals.data_ptr(), 0, 4, op.rows.data_ptr(), op.colptr.data_ptr(),
            op.col_tiles.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "K9a":
        err = lib.adaprox_bcsr_rmatvec(*ptrs, y.data_ptr(), nbc, bm, bn, out.data_ptr(), stream)
    else:
        part = torch.empty(nnzb * bn, device=dev)
        err = lib.adaprox_bcsr_rmatvec_slab(*ptrs, nnzb, y.data_ptr(), nbc, bm, bn,
                                            part.data_ptr(), out.data_ptr(), stream)
    torch.cuda.synchronize()
    assert err == 0 and _sparse_err(out, want, scale) > SPARSE_RTOL


def test_k9_cold_rates_at_the_sparse_case_within_the_card(dev):
    """At the slice's case (8192 x 16384 f32, 10% of the (64, 512) tiles: 407 tiles, 53 MB),
    the L2-flushed rate of K9a's and K9b's A'y over A's tiles and of K9b's A x (the bytes
    each must move over its time, a 256 MiB buffer written between calls) is at or under
    the card's data-sheet rate, and each result agrees with its plain version."""
    from adaprox_tpu_torch.experiments.sparse_calibration import sparse_case
    from adaprox_tpu_torch.ops import bcsr as tb

    roof = chip_bandwidth_gbps(dev)
    assert math.isfinite(roof), f"no data-sheet rate for {torch.cuda.get_device_name(dev)}"
    d = sparse_case()
    vals, cols, rowptr, _ = tb.bcsr_from_dense(d)
    m, n = d.shape
    del d
    op = tb.BCSROperator.from_arrays(vals, cols, rowptr, vals[:1], cols[:1], [0, 1], (m, n),
                                     device=dev)
    nbr, nbc = op.rowptr.shape[0] - 1, op.colptr.shape[0] - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    x, y = torch.randn(n, generator=gen, device=dev), torch.randn(m, generator=gen, device=dev)
    t_args = (op.vals, op.rows, op.colptr, op.col_tiles, nbc, y)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    t_plain = tb.bcsr_rmatvec_plain(*t_args[:4], y, nbc)
    t_scale = tb.bcsr_rmatvec_plain(op.vals.abs(), *t_args[1:4], y.abs(), nbc).max()
    t_bytes = nbytes(op.vals, op.rows, op.colptr, op.col_tiles, y, x)
    cases = {
        "K9a A'y": (lambda: tb.bcsr_rmatvec(*t_args), t_plain, t_scale, t_bytes),
        "K9b A'y": (lambda: tb.bcsr_rmatvec_slab(*t_args), t_plain, t_scale, t_bytes),
        "K9b A x": (lambda: tb.bcsr_matvec_slab(op.vals, op.cols, op.rows, nbr, x),
                    tb.bcsr_matvec_plain(op.vals, op.cols, op.rows, x, nbr, rowptr=op.rowptr),
                    tb.bcsr_matvec_plain(op.vals.abs(), op.cols, op.rows, x.abs(), nbr,
                                         rowptr=op.rowptr).max(),
                    nbytes(op.vals, op.cols, op.rows, x, y))}
    gbps = {}
    for name, (kernel, want, scale, moved) in cases.items():
        assert _sparse_err(kernel(), want, scale) <= SPARSE_RTOL, name
        gbps[name] = moved / flushed_ms(kernel) / 1e6
    print(f"cold GB/s at the sparse case against the data sheet's {roof:g}: {gbps}")
    assert all(v <= roof for v in gbps.values()), gbps


def _sparse_launches():
    from adaprox_tpu_torch.ops import bcsr as tb
    from adaprox_tpu_torch.ops import sparse as ts

    return (ts.ell_matvec.launches, tb.bcsr_matvec.launches, tb.bcsr_matvec_slab.launches)


@pytest.mark.parametrize("route", ["ell", "pallas", "slab", "xla", "dense"])
def test_lasso_engine_over_operators_on_card(dev, route):
    """AdaPGM through adaptive_proxgrad on a lasso with LeastSquares(a=op) on the card:
    the route's kernel launched once a matvec, two an oracle call (f_evals), the "xla"
    and dense routes launching none of the three; the "xla" route's matvec the same bits
    twice; the objective after 200 iterations within 1e-4 of the dense route's."""
    import adaprox_tpu_torch as apt

    d = _bcsr_case(dev, 1024, 4096, (64, 512), 0.2, seed=5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    b = torch.randn(1024, generator=gen, device=dev)
    lam = 0.1 * float((d.t() @ b).abs().max())
    ops = {"ell": lambda: apt.ELLOperator.from_dense(d),
           "dense": lambda: apt.DenseOperator(d)}
    op = ops.get(route, lambda: apt.BCSROperator.from_dense(d, kernel=route))()
    if route == "xla":
        assert torch.equal(op.matvec(b.new_ones(4096)), op.matvec(b.new_ones(4096)))
    gamma = 1.0 / float(torch.linalg.matrix_norm(d, 2)) ** 2
    kw = dict(g=apt.L1Norm(lam), rule=apt.AdaPGMRule(gamma=gamma), tol=0.0, maxit=200)
    before = _sparse_launches()
    res = apt.adaptive_proxgrad(torch.zeros(4096, device=dev), f=apt.LeastSquares(op, b), **kw)
    torch.cuda.synchronize()
    got = [a - c for a, c in zip(_sparse_launches(), before)]
    calls = 2 * res.counters.f_evals
    want = {"ell": [calls, 0, 0], "pallas": [0, calls, 0], "slab": [0, 0, calls]}
    assert got == want.get(route, [0, 0, 0]) and res.numit == 200
    ref = apt.adaptive_proxgrad(torch.zeros(4096, device=dev), f=apt.LeastSquares(d, b), **kw)
    obj = float(apt.LeastSquares(d, b).value(res.x) + kw["g"](res.x))
    obj_ref = float(apt.LeastSquares(d, b).value(ref.x) + kw["g"](ref.x))
    assert abs(obj - obj_ref) <= 1e-4 * abs(obj_ref)


# -- K2b, the batch of independent solves ----------------------------------------------


def k2b_case(dev, obj, dtype, bsz=4, seed=20):
    """``bsz`` problems of one shape (ls: 500x300 lasso; logreg: 384x128 with a
    ones column and 8 zero-padded rows; cubic: 256^2 H = G'G/16 + 0.1 I, G = randn/16), each
    with its own A, b and scalars; A stored in ``dtype``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if obj == "cubic":
        g = torch.randn(bsz, 256, 256, generator=gen, device=dev) / 16
        a = g.transpose(1, 2) @ g / 16 + 0.1 * torch.eye(256, device=dev)
        b = torch.randn(bsz, 256, generator=gen, device=dev) / 16
        # ||x*|| stays near 2, where the cubic term adds at most 4c to the curvature: the
        # fixed momentum step 1 / (||H|| + 4c) is stable
        gam = [1.0 / (float(torch.linalg.matrix_norm(a[i].double(), 2)) + 4 * (0.5 + i))
               for i in range(bsz)]
        scal = torch.tensor([[gam[i], 1e-5, 0.0, 0.0, 0.5 + i] for i in range(bsz)])
        kw = dict(prox_kind="zero", obj_kind="cubic")
    elif obj == "logreg":
        a = torch.randn(bsz, 384, 128, generator=gen, device=dev) / 8
        a[:, :, -1] = 1.0
        a[:, 376:] = 0.0
        b = (torch.rand(bsz, 384, generator=gen, device=dev) < 0.5).float()
        b[:, 376:] = 0.0
        scal = torch.tensor([[4.0, 1e-5, 0.01 * (i + 1), 0.0] for i in range(bsz)])
        kw = dict(obj_kind="logreg", m_true=376.0)
    else:
        a = torch.randn(bsz, 500, 300, generator=gen, device=dev) / 300**0.5
        b = torch.randn(bsz, 500, generator=gen, device=dev)
        gam = [1.0 / float(torch.linalg.matrix_norm(a[i].double(), 2) ** 2) for i in range(bsz)]
        lam = [0.1 * float((a[i].t() @ b[i]).abs().max()) for i in range(bsz)]
        scal = torch.tensor([[gam[i], 1e-5, lam[i], 0.0] for i in range(bsz)])
        kw = dict(obj_kind="ls")
    return a.to(dtype).contiguous(), b, torch.zeros(bsz, a.shape[2], device=dev), scal, kw


def _same_bits(u, w):
    """Bit for bit (a NaN equals the same NaN)."""
    if u.dtype == torch.float32:
        u, w = u.view(torch.int32), w.view(torch.int32)
    return torch.equal(u, w)


def _k2b_singles(a, b, x0, scal, maxit, **kw):
    """Each instance as its own K2 launch, with the f32 values of its scal row."""
    kw = dict(kw)
    obj, m_true = kw.pop("obj_kind"), kw.pop("m_true", None)
    rule, mom = kw.pop("rule_kind", "adapgm"), kw.pop("momentum", False)
    outs = []
    for i in range(a.shape[0]):
        sc = scal[i].float().tolist() + [0.0] * (5 - scal.shape[1])
        outs.append(tr.resident_adapgm(a[i], b[i], x0[i], sc[0], sc[1], maxit, p1=sc[2],
                                       p2=sc[3], cube_c=sc[4], obj_kind=obj, m_true=m_true,
                                       rule_kind=rule, momentum=mom, **kw))
    return outs


@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule,momentum", [("adapgm", False), ("mm", False), ("fixed", True)])
def test_k2b_instances_equal_single_k2_launches(dev, obj, dtype, rule, momentum):
    """Instance i of one K2b launch is its own K2 launch bit for bit: x, numit,
    norm_res and converged (one launch, counted)."""
    a, b, x0, scal, kw = k2b_case(dev, obj, dtype)
    before = tr.resident_adapgm_batch.launches
    got = tr.resident_adapgm_batch(a, b, x0, scal, 2000, rule_kind=rule, momentum=momentum,
                                   **kw)
    torch.cuda.synchronize()
    assert tr.resident_adapgm_batch.launches == before + 1
    assert got[0].shape == x0.shape and got[1].dtype == torch.int32
    for i, one in enumerate(_k2b_singles(a, b, x0, scal, 2000, rule_kind=rule,
                                         momentum=momentum, **kw)):
        for u, w in zip(got, one[:4]):
            assert _same_bits(u[i], w), i
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("obj", ["ls", "logreg"])
def test_k2b_shared_a_equals_materialized(dev, obj, dtype):
    """One A expanded over the batch (stride 0, read from its one copy) gives the
    materialized batch's bits, and each instance its K2 launch's."""
    a, b, x0, scal, kw = k2b_case(dev, obj, dtype)
    shared = a[0].expand(4, *a.shape[1:])
    bb = b[0].expand(4, -1).contiguous()
    got = tr.resident_adapgm_batch(shared, bb, x0, scal, 1000, **kw)
    want = tr.resident_adapgm_batch(shared.contiguous(), bb, x0, scal, 1000, **kw)
    torch.cuda.synchronize()
    for u, w in zip(got, want):
        assert torch.equal(u, w)
    for i, one in enumerate(_k2b_singles(shared, bb, x0, scal, 1000, **kw)):
        assert torch.equal(got[0][i], one[0]) and int(got[1][i]) == int(one[1])


def test_k2b_matches_plain_on_card(dev):
    """The fixed rule does not amplify rounding: 30 iterations within K2's 1e-5."""
    a, b, x0, scal, kw = k2b_case(dev, "ls", torch.float32)
    scal[:, 1] = 0.0
    got = tr.resident_adapgm_batch(a, b, x0, scal, 30, rule_kind="fixed", **kw)
    want = tr.resident_adapgm_batch_plain(a, b, x0, scal, 30, rule_kind="fixed", **kw)
    assert got[1].tolist() == want[1].tolist() == [30] * 4
    for i in range(4):
        assert float((got[0][i] - want[0][i]).abs().max()) <= 1e-5 * float(
            want[0][i].abs().max())


def test_k2b_refuses_what_it_does_not_take(dev):
    a, b, x0, scal, kw = k2b_case(dev, "ls", torch.float32)
    with pytest.raises(TypeError, match="float32 b and x0"):
        tr.resident_adapgm_batch(a, b.double(), x0, scal, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tr.resident_adapgm_batch(a.double(), b, x0, scal, 5)
    with pytest.raises(ValueError, match="contiguous"):
        tr.resident_adapgm_batch(a.transpose(1, 2).contiguous().transpose(1, 2), b, x0,
                                 scal, 5)
    with pytest.raises(ValueError, match="contiguous"):
        tr.resident_adapgm_batch(a, b, torch.zeros(300, 4, device=dev).t(), scal, 5)
    with pytest.raises(ValueError, match="dynamic"):
        tr.resident_adapgm_batch(a, b, x0, scal, 5, rule_kind="dynamic")


# -- K10a-c, the stream probes ----------------------------------------------------------


def _stream_input(dev, shape, dtype, seed=30):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,repeats", [((64, 256), 3), ((1000, 1000), 2), ((3, 5), 1),
                                           ((4096, 4096), 4)])
def test_k10a_matches_plain_on_card(dev, dtype, shape, repeats):
    # all positive: 1e-5 of the sum is not loosened by cancellation
    a = _stream_input(dev, shape, dtype).abs()
    before = tk.hbm_read_reduce.launches
    got = tk.hbm_read_reduce(a, scale=0.5, block_rows=shape[0], repeats=repeats)
    torch.cuda.synchronize()
    assert tk.hbm_read_reduce.launches == before + 1
    want = tk.hbm_read_reduce_plain(a, 0.5, repeats=repeats)
    tol = 1e-5 * abs(float(want))
    assert got.dtype == torch.float32 and abs(float(got) - float(want)) <= tol
    assert torch.equal(got, tk.hbm_read_reduce(a, scale=0.5, block_rows=shape[0],
                                               repeats=repeats))


def test_k10a_check_fails_a_probe_that_skips_its_tail(dev, tmp_path):
    """chip_smoke.py's K10a check (|randn| / 128 at 16384^2 f32, 200 passes, within
    1e-5 of the plain sum) passes K10a and fails a K10a built without its
    remainder loop: that one skips the vectors past its last whole unrolled step
    (65536 of 67M on 132 SMs) and would read as a faster stream."""
    src = tk.STREAM_SOURCE.read_text()
    tail = "    for (; i < nvec; i += stride) acc += vec_sum(ld_stream(av + i), T{});\n"
    assert src.count(tail) == 1
    mutant, so = tmp_path / "hbm_stream.cu", tmp_path / "hbm_stream_no_tail.so"
    mutant.write_text(src.replace(tail, ""))
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-I", str(tk.STREAM_SOURCE.parent), "-o",
                    str(so), str(mutant)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.adaprox_hbm_max_grid.restype = ctypes.c_int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adaprox_hbm_read_reduce.argtypes = [p, i, ll, i, ctypes.c_float, p, ll, p, p]
    lib.adaprox_hbm_read_reduce.restype = i

    a = _stream_input(dev, (16384, 16384), torch.float32).abs_() / 128
    want = float(tk.hbm_read_reduce_plain(a, 0.5, repeats=200))
    tol = 1e-5 * want
    assert abs(float(tk.hbm_read_reduce(a, 0.5, repeats=200)) - want) <= tol
    part = torch.empty(lib.adaprox_hbm_max_grid(), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    assert lib.adaprox_hbm_read_reduce(a.data_ptr(), 0, a.numel(), 200, 0.5, part.data_ptr(),
                                       part.numel(), out.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream) == 0
    torch.cuda.synchronize()
    assert abs(float(out) - want) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,repeats", [((64, 256), 3), ((1000, 1000), 2), ((7, 129), 1)])
def test_k10b_matches_plain_on_card(dev, dtype, shape, repeats):
    a = _stream_input(dev, shape, dtype)
    out, out_p = torch.empty_like(a), torch.empty_like(a)
    before = tk.hbm_copy.launches
    got = tk.hbm_copy(a, scale=0.3, block_rows=shape[0], repeats=repeats, out=out)
    torch.cuda.synchronize()
    assert tk.hbm_copy.launches == before + 1
    want = tk.hbm_copy_plain(a, 0.3, repeats=repeats, out=out_p)
    assert torch.equal(out, out_p) and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk_rows,depth,repeats", [
    ((64, 256), 16, 2, 1), ((64, 256), 16, 3, 2), ((64, 256), 32, 4, 3), ((64, 256), 64, 4, 1),
    ((1024, 4096), 128, 3, 2), ((1024, 16384), 128, 8, 1), ((96, 136), 8, 5, 3)])
def test_k10c_matches_plain_on_card(dev, dtype, shape, chunk_rows, depth, repeats):
    a = _stream_input(dev, shape, dtype)
    before = tk.hbm_dma_read.launches
    got = tk.hbm_dma_read(a, scale=2.0, chunk_rows=chunk_rows, depth=depth, repeats=repeats)
    torch.cuda.synchronize()
    assert tk.hbm_dma_read.launches == before + 1
    want = tk.hbm_dma_read_plain(a, 2.0, chunk_rows, depth, repeats)
    tol = 1e-5 * (256 + repeats * float(a[::chunk_rows, :128].float().abs().sum()))
    assert abs(float(got) - float(want)) <= tol
    assert torch.equal(got, tk.hbm_dma_read(a, scale=2.0, chunk_rows=chunk_rows, depth=depth,
                                            repeats=repeats))


def test_k10c_reads_every_pass_from_device_memory(dev, tmp_path):
    """K10c deals a pass's pieces to its CTAs the same way in every pass, so a
    CTA rereads only its own pieces, a pass later. At 256 MiB (five times the
    50 MB L2), 800 passes, it then reads no faster than the card's memory can
    give. A K10c that deals the pieces of all passes round robin reads past
    that: a CTA's pieces shift from pass to pass, the CTAs drift a pass apart,
    and one reads from the L2 what another has just fetched."""
    src = tk.STREAM_SOURCE.read_text()
    deal = ("  const long long per_pass = (chunks * pieces - blockIdx.x + grid - 1) / grid;\n"
            "  const long long mine = per_pass * repeats;\n")
    pick = "  auto piece_of = [&](long long t) { return blockIdx.x + (t % per_pass) * grid; };\n"
    assert src.count(deal) == 1 and src.count(pick) == 1
    mutant, so = tmp_path / "hbm_stream.cu", tmp_path / "hbm_stream_shifting_deal.so"
    mutant.write_text(src.replace(deal, (
        "  const long long per_pass = chunks * pieces;\n"
        "  const long long mine = (per_pass * repeats - blockIdx.x + grid - 1) / grid;\n")
    ).replace(pick, "  auto piece_of = [&](long long t) { return (blockIdx.x + t * grid) % "
                    "per_pass; };\n"))
    subprocess.run([tk._nvcc(), *tk.NVCC_FLAGS, "-I", str(tk.STREAM_SOURCE.parent), "-o",
                    str(so), str(mutant)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.adaprox_hbm_max_grid.restype = ctypes.c_int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adaprox_hbm_dma_read.argtypes = [p, i, ll, ll, i, i, ctypes.c_float, p, ll, p, p]
    lib.adaprox_hbm_dma_read.restype = i

    a = _stream_input(dev, (4096, 16384), torch.float32).abs_() / 128
    reps, chunk_bytes = 800, 128 * a.shape[1] * a.element_size()
    part = torch.empty(128 * lib.adaprox_hbm_max_grid(), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)

    def shifting():
        assert lib.adaprox_hbm_dma_read(a.data_ptr(), 0, a.shape[0] // 128, chunk_bytes, 3,
                                        reps, 0.5, part.data_ptr(), part.numel(),
                                        out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream) == 0
        return out

    roof = chip_bandwidth_gbps(dev)
    assert math.isfinite(roof), f"no data-sheet rate for {torch.cuda.get_device_name(dev)}"
    want = float(tk.hbm_dma_read_plain(a, 0.5, repeats=reps))
    gbps = {}
    for name, fn in (("K10c", lambda: tk.hbm_dma_read(a, 0.5, repeats=reps)),
                     ("shifting deal", shifting)):
        seconds, got = timed(fn)
        assert abs(float(got) - want) <= 1e-5 * want
        gbps[name] = reps * a.numel() * a.element_size() / seconds / 1e9
    print(f"K10c at 4096x16384 f32, {reps} passes, GB/s (best of 3) against the data "
          f"sheet's {roof:g}: {gbps}")
    assert gbps["K10c"] <= roof < gbps["shifting deal"], gbps


def test_k10_refuse_what_they_do_not_take(dev):
    a = _stream_input(dev, (64, 256), torch.float32)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_read_reduce(a, block_rows=24)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_copy(a, block_rows=7)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_dma_read(a, chunk_rows=48)
    for probe, rows in ((tk.hbm_read_reduce, "block_rows"), (tk.hbm_copy, "block_rows"),
                        (tk.hbm_dma_read, "chunk_rows")):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            probe(a.double(), **{rows: 64})
        with pytest.raises(ValueError, match="contiguous"):
            probe(a[:, ::2], **{rows: 64})
    # 500 copies in flight leave 256 bytes a piece: no room for a 128-value token row
    with pytest.raises(ValueError, match="no room"):
        tk.hbm_dma_read(a, chunk_rows=1, depth=500, repeats=8)
