"""``LeastSquares`` and the proximal-gradient engine of the PyTorch port
against the JAX package, on the same numpy inputs (f64 on the CPU).

The JAX side runs ``LeastSquares(fused=True)`` through its Pallas kernel in
interpret mode; the port's ``fused=True`` takes K1's plain version on CPU
tensors.

About the tolerances of the slice. The two sides sum in different orders
(XLA vs BLAS), so they differ by ~1e-16 after the first matvec. The fixed
step contracts that difference; the adaptive rules amplify it, because each
step size is a ratio of iterate differences: on this problem AdaPGM's step
sizes drift apart by about 10x every five iterations (2e-16 at iteration 5,
1e-11 at 20, 1e-8 at 40) and MM's stay near 1e-14 until iteration ~70. JAX's
own fused and two-matmul paths stop 12 iterations apart at tol 1e-6 for the
same reason. So every row is held to rtol 1e-9 over a horizon where the
measured drift is at least 100x below it (fixed 300 iterations, MM 60,
AdaPGM 20), with equal numit and counters; and separately both sides must
converge, to the same solution, when run to tol.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, lasso_case, np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
from adaprox_tpu.models.objectives import LeastSquares as JLS

F64 = torch.float64


# -- (c) LeastSquares --------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_least_squares_matches_jax(fused):
    m, n = 64, 128  # tile-aligned, so the JAX side really takes its kernel
    a, b = gaussian(0, m, n), gaussian(1, m)
    x, x_prev = gaussian(2, n), gaussian(3, n)
    fj = JLS(a=jnp.asarray(a), b=jnp.asarray(b), fused=fused)
    ft, _ = apt.lasso_from_numpy(a, b, 1.0, device="cpu", dtype=F64, fused=fused)
    assert dict(ft.named_buffers()).keys() == {"a", "b"}

    vj, auxj = fj.value_and_aux(jnp.asarray(x))
    vt, auxt = ft.value_and_aux(torch.from_numpy(x))
    # n- and m-term sums in another order: rtol ~ (m + n) * eps
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    aux_scale = np.abs(np_of(auxj)).max()
    np.testing.assert_allclose(np_of(auxt), np_of(auxj), rtol=0, atol=1e-12 * aux_scale)
    assert auxt.shape == ((n,) if fused else (m,))  # fused aux is the gradient

    gj, gt = fj.grad(jnp.asarray(x)), ft.grad(torch.from_numpy(x))
    np.testing.assert_allclose(np_of(gt), np_of(gj), rtol=0, atol=1e-12 * np.abs(np_of(gj)).max())
    vgt = ft.value_and_grad(torch.from_numpy(x))
    np.testing.assert_allclose(np_of(vgt[1]), np_of(gt), rtol=0, atol=0)
    assert float(ft(torch.from_numpy(x))) == float(vt)  # nn.Module call = value

    _, auxj0 = fj.value_and_aux(jnp.asarray(x_prev))
    _, auxt0 = ft.value_and_aux(torch.from_numpy(x_prev))
    dx = x - x_prev
    bj = fj.bregman_from_aux(jnp.asarray(dx), auxj, auxj0)
    bt = ft.bregman_from_aux(torch.from_numpy(dx), auxt, auxt0)
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-11)
    np.testing.assert_allclose(float(bt), 0.5 * np.sum((a @ dx) ** 2), rtol=1e-11)
    # the fused form clamps at its exact lower bound 0, like JAX's
    z = torch.zeros(n, dtype=F64)
    assert float(ft.bregman_from_aux(z, auxt, auxt)) == 0.0


def test_least_squares_bf16_storage_accumulates_in_iterate_dtype():
    a = gaussian(4, 16, 32).astype(np.float32)
    ft, _ = apt.lasso_from_numpy(a, gaussian(5, 16), 1.0, device="cpu",
                                 dtype=torch.bfloat16, fused=False)
    assert ft.a.dtype == torch.bfloat16 and ft.b.dtype == torch.float32
    v, res = ft.value_and_aux(torch.ones(32))
    assert v.dtype == torch.float32 and res.dtype == torch.float32


# -- (d) the slice: the engine on the padded known-optimum lasso ------------


def _solve(side, kind, fused, history, tol, maxit):
    a, b, lam, _, gamma0 = lasso_case()
    if side == "jax":
        f, g = JLS(a=jnp.asarray(a), b=jnp.asarray(b), fused=fused), ap.L1Norm(lam=jnp.asarray(lam))
        mod, x0 = ap, jnp.zeros(a.shape[1])
    else:
        f, g = apt.lasso_from_numpy(a, b, lam, device="cpu", dtype=F64, fused=fused)
        mod, x0 = apt, torch.zeros(a.shape[1], dtype=F64)
    kw = dict(f=f, g=g, tol=tol, maxit=maxit, history=history)
    if kind == "fixed":
        return mod.fixed_proxgrad(x0, gamma=gamma0, **kw), f, g
    rule = (mod.MalitskyMishchenkoRule if kind == "mm" else mod.AdaPGMRule)(gamma=gamma0)
    return mod.adaptive_proxgrad(x0, rule=rule, **kw), f, g


HORIZON = {"fixed": 300, "mm": 60, "adapgm": 20}


@pytest.mark.parametrize("history", [True, False])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["fixed", "mm", "adapgm"])
def test_slice_rows_match_jax(kind, fused, history):
    maxit = HORIZON[kind]
    rj, _, _ = _solve("jax", kind, fused, history, tol=1e-6, maxit=maxit)
    rt, _, _ = _solve("torch", kind, fused, history, tol=1e-6, maxit=maxit)
    assert rt.numit == int(rj.numit) == maxit
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    np.testing.assert_allclose(float(rt.norm_res), float(rj.norm_res), rtol=1e-9)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)
    assert not bool(rt.diag["rule_nan"]) and not bool(rj.diag["rule_nan"])
    if not history:
        assert rt.records is None
        return
    valid = np_of(rj.records.valid).astype(bool)
    assert len(rt.records.it) == valid.sum() and bool(rt.records.valid.all())
    for k in ("gamma", "sigma", "norm_res", "objective"):
        np.testing.assert_allclose(np_of(getattr(rt.records, k)),
                                   np_of(getattr(rj.records, k))[valid], rtol=1e-9)
    for k in ("it", "f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals",
              "A_evals", "At_evals"):
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k))[valid])


@pytest.mark.parametrize("history", [True, False])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["mm", "adapgm"])
def test_slice_converges_to_jax_solution(kind, fused, history):
    tol, maxit = 1e-8, 3000
    rj, fj, gj = _solve("jax", kind, fused, history, tol=tol, maxit=maxit)
    rt, ft, gt = _solve("torch", kind, fused, history, tol=tol, maxit=maxit)
    for r in (rj, rt):
        numit = int(r.numit)
        assert numit < maxit and float(r.norm_res) <= tol
        # at convergence the counters are the at-check snapshot
        c = [int(v) for v in r.counters]
        assert c[:3] == [numit + 1, numit + 1, numit]
    # measured: both sides stop within 3% of each other's iteration count
    # (JAX's own fused and two-matmul paths: 1.4%); another BLAS may differ
    assert abs(rt.numit - int(rj.numit)) <= 0.1 * int(rj.numit)
    # the same minimizer: ||x_t - x_j|| is bounded by the stopping residual
    # (measured 1.7e-10 relative at tol 1e-8)
    xj, xt = np_of(rj.x), np_of(rt.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    fx_t = float(ft.value(rt.x) + gt(rt.x))
    np.testing.assert_allclose(fx_t, float(fj.value(rj.x) + gj(rj.x)), rtol=1e-12)
    if history:
        # the returned x is the one at the convergence check (the reference's
        # return value), whose objective the last row records
        assert len(rt.records.it) == rt.numit
        np.testing.assert_allclose(float(rt.records.objective[-1]), fx_t, rtol=1e-14)
        assert float(rt.records.norm_res[-1]) <= tol < float(rt.records.norm_res[-2])


def test_slice_zero_iterations_matches_jax():
    rj, _, _ = _solve("jax", "adapgm", False, False, tol=1e-6, maxit=0)
    rt, _, _ = _solve("torch", "adapgm", False, False, tol=1e-6, maxit=0)
    assert rt.numit == int(rj.numit) == 0 and float(rt.norm_res) == float(rj.norm_res) == np.inf
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-12, atol=1e-15)


def test_rule_nan_latch_matches_jax():
    """A rule built directly (not through .make) with gamma past the coupling
    bound 1/(2 t ||A|| (1 + delta)) takes the square root of a negative
    number at its first update. Both engines latch the NaN step in
    diag["rule_nan"] and run to maxit instead of stopping."""
    a, b, lam, _, gamma0 = lasso_case()
    kw = dict(gamma=gamma0, norm_a=float(np.linalg.norm(a, 2)), delta=100.0)
    rj = ap.adaptive_proxgrad(jnp.zeros(a.shape[1]), f=JLS(a=jnp.asarray(a), b=jnp.asarray(b)),
                              g=ap.L1Norm(lam=lam), rule=ap.AdaPGMRule(**kw),
                              tol=1e-6, maxit=5)
    f, g = apt.lasso_from_numpy(a, b, lam, device="cpu", dtype=F64, fused=False)
    rt = apt.adaptive_proxgrad(torch.zeros(a.shape[1], dtype=F64), f=f, g=g,
                               rule=apt.AdaPGMRule(**kw), tol=1e-6, maxit=5)
    assert bool(rt.diag["rule_nan"]) and bool(rj.diag["rule_nan"])
    assert rt.numit == int(rj.numit) == 5


@pytest.mark.parametrize("kw,exc", [
    (dict(A=object(), y0=torch.zeros(3)), NotImplementedError),
    (dict(resume_state=object()), NotImplementedError),
    (dict(scalar_dtype=torch.float64), NotImplementedError),
    (dict(it_cap=5), NotImplementedError),
    (dict(h=apt.L1Norm(1.0)), ValueError),
])
def test_engine_refuses_what_is_not_ported(kw, exc):
    f, g = apt.lasso_from_numpy(np.eye(3), np.ones(3), 0.1, device="cpu", dtype=F64,
                                fused=False)
    with pytest.raises(exc, match="ROADMAP|without A"):
        apt.adaptive_primal_dual(torch.zeros(3, dtype=F64), f=f, g=g,
                                 rule=apt.AdaPGMRule(gamma=0.1), maxit=2, **kw)
    # h = Zero without A is the PG case itself, as in the JAX engine
    res = apt.adaptive_primal_dual(torch.zeros(3, dtype=F64), f=f, g=g, h=apt.Zero(),
                                   rule=apt.AdaPGMRule(gamma=0.1), maxit=2)
    assert res.numit == 2 and res.name == "AdaPDM"
