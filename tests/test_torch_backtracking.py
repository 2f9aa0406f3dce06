"""The backtracking family of the PyTorch port against the JAX package, on the
same numpy inputs (f64 on the CPU): the engine solvers
``backtracking_proxgrad`` and ``backtracking_nesterov``, the backtracking
whole-solve kernel K4 (``resident_backtracking``) and its sweep K4b
(``resident_bt_sweep``) through their plain versions, the records built from
the trial counts, and the lasso driver's ``--resident`` JSONL.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's wrappers take their plain versions on
CPU tensors. The CUDA kernels are tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py.

About the horizons. The two sides sum in different orders, so they differ by
~1e-16 after the first matvec; a backtracking trial that sits on the
knife-edge of the sufficient-descent test can then take the other branch,
and from there the two runs part. That happens once a solve has converged to
the f64 noise floor, where f(z) - f(x) is rounding: measured on the CPU in
f64 over 200 iterations of the engine cases below, the first step size past
rtol 1e-9 came at iteration 35 (cubic model, xi 1.5), 43 (xi 2), 69 (xi 1)
and 167 (Nesterov), 88 and 94 on the logistic problem (xi 2 and 1.5), and
never on the lasso and the worst case; before that the rows agree to ~1e-15.
So the cubic cases run 30 iterations, the logistic and worst-case ones 60
and the lasso 100 (JAX's own resident-vs-engine test holds 60), each held to
rtol 1e-9 over the whole run, with the trial counts and the counters exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of
from test_reference_mirror import np_backtracking

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import lasso as jlasso
from adaprox_tpu.models.objectives import Cubic as JCubic
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.models.objectives import LogisticLoss as JLogisticLoss
from adaprox_tpu.models.objectives import WorstQuadratic as JWorstQuadratic
from adaprox_tpu.models.synthetic import random_lasso
from adaprox_tpu.ops import resident_bt as jrb
from adaprox_tpu_torch.experiments import lasso as tlasso
from adaprox_tpu_torch.ops import resident_bt as trb

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective", "trials")
COUNTERS = ("f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals", "At_evals")


@functools.lru_cache(maxsize=None)
def _lasso():
    """JAX's own resident-backtracking case: random_lasso(64, 128, 8, seed=3),
    gamma0 = 10 / ||A||^2, so the trials shrink."""
    prob = random_lasso(m=64, n=128, pfactor=8, seed=3)
    return prob.a, prob.b, 10.0 / float(np.linalg.norm(prob.a, 2) ** 2)


@functools.lru_cache(maxsize=None)
def _logistic():
    """60 rows of 13 sparse features and labels; [X 1] padded to 64x128 for
    the kernel (m_true 60)."""
    x = gaussian(11, 60, 13) * (gaussian(12, 60, 13) > 0.5)
    y = (x @ gaussian(13, 13) + 0.3 * gaussian(14, 60) > 0).astype(float)
    x1 = np.hstack([x, np.ones((60, 1))])
    lf = float(np.linalg.norm(x1, 2) ** 2 / (4 * 60))
    a = np.zeros((64, 128))
    a[:60, :14] = x1
    b = np.zeros(64)
    b[:60] = y
    return x, y, a, b, 10.0 / lf


@functools.lru_cache(maxsize=None)
def _cubic():
    """A PSD 14x14 H (a logistic Hessian's shape) and q, padded to 128."""
    g = gaussian(21, 40, 14) / np.sqrt(40)
    h = g.T @ g
    q = gaussian(22, 14) / 14
    hp, qp = np.zeros((128, 128)), np.zeros(128)
    hp[:14, :14], qp[:14] = h, q
    return h, q, hp, qp, 10.0 / float(np.linalg.norm(h, 2))


def _engine_case(side, kind, fused=False):
    """(f, g, x0, gamma0, maxit) of an engine case on ``side``."""
    if side == "jax":
        x0 = jnp.zeros
    else:
        def x0(n):
            return torch.zeros(n, dtype=F64)
    if kind == "ls":
        a, b, gam = _lasso()
        if side == "jax":
            return JLS(a=jnp.asarray(a), b=jnp.asarray(b), fused=fused), ap.L1Norm(
                lam=jnp.float64(1.0)), x0(128), gam, 100
        f, g = apt.lasso_from_numpy(a, b, 1.0, device="cpu", dtype=F64, fused=fused)
        return f, g, x0(128), gam, 100
    if kind == "logreg":
        x, y, _, _, gam = _logistic()
        if side == "jax":
            return (JLogisticLoss(x=jnp.asarray(x), y=jnp.asarray(y)),
                    ap.L1Norm(lam=jnp.float64(0.01)), x0(14), gam, 60)
        f, g = apt.logreg_from_numpy(x, y, 0.01, device="cpu", dtype=F64, fused=fused)
        return f, g, x0(14), gam, 60
    if kind == "cubic":
        h, q, _, _, gam = _cubic()
        if side == "jax":
            return (JCubic(q_mat=jnp.asarray(h), q_vec=jnp.asarray(q), c=jnp.asarray(1.0)),
                    ap.Zero(), x0(14), gam, 30)
        f = apt.cubic_from_numpy(h, q, 1.0, device="cpu", dtype=F64)
        return f, apt.Zero(), x0(14), gam, 30
    # the worst case on 10 of 12 coordinates, from gamma0 = 1 as its driver runs it
    if side == "jax":
        return JWorstQuadratic(k=10, lip=jnp.asarray(100.0)), ap.Zero(), x0(12), 1.0, 60
    f = apt.worst_from_numpy(10, 100.0, 12, device="cpu", dtype=F64)
    return f, apt.Zero(), x0(12), 1.0, 60


def _engine(side, kind, method, *, fused=False, tol=0.0, maxit=None, **kw):
    f, g, x0, gam, case_maxit = _engine_case(side, kind, fused)
    mod = ap if side == "jax" else apt
    if method == "nesterov":
        solver = mod.backtracking_nesterov
    else:
        solver = functools.partial(mod.backtracking_proxgrad, xi=float(method))
    return solver(x0, f=f, g=g, gamma0=gam, tol=tol, maxit=maxit or case_maxit, history=True,
                  **kw)


def _records_match(rt, rj):
    valid = np_of(rj.records.valid).astype(bool)
    assert len(rt.records.it) == valid.sum() == rt.numit == int(rj.numit)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        np.testing.assert_allclose(np_of(getattr(rt.records, k)),
                                   np_of(getattr(rj.records, k))[valid], rtol=1e-9, err_msg=k)
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k))[valid], err_msg=k)
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)


# -- the engine --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["1.0", "1.5", "2.0", "nesterov"])
@pytest.mark.parametrize("kind,fused", [("ls", False), ("ls", True), ("logreg", False),
                                        ("logreg", True), ("cubic", False), ("worst", False)])
def test_engine_rows_match_jax(kind, fused, method):
    """Records, trial-driven counters and the final point, tol 0 (every
    iteration runs); the fused oracles take K1's and K3's plain versions."""
    rj = _engine("jax", kind, method, fused=fused)
    rt = _engine("torch", kind, method, fused=fused)
    _records_match(rt, rj)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)
    for k in ("gamma", "stepsize_underflow", "trials_exhausted"):
        np.testing.assert_allclose(np_of(rt.diag[k]), np_of(rj.diag[k]), rtol=1e-9)
    if kind != "worst":  # (from gamma0 = 1 the worst case's first trial already holds)
        assert int(rt.records.prox_g_evals[-1]) > rt.numit  # some trial shrank


@pytest.mark.parametrize("method", ["1.5", "nesterov"])
@pytest.mark.parametrize("kind", ["ls", "cubic"])
def test_engine_converges_like_jax(kind, method):
    """Solved to tol: the same numit, counters (the at-check snapshot) and x."""
    tol = 1e-6
    rj = _engine("jax", kind, method, tol=tol, maxit=3000)
    rt = _engine("torch", kind, method, tol=tol, maxit=3000)
    assert rt.numit == int(rj.numit) < 3000 and float(rt.norm_res) <= tol
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["1.5", "nesterov"])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_exact_bregman_matches_jax(fused, method):
    """The exact-Bregman test (LeastSquares has the form, both auxes)."""
    rj = _engine("jax", "ls", method, fused=fused, exact_bregman=True)
    rt = _engine("torch", "ls", method, fused=fused, exact_bregman=True)
    _records_match(rt, rj)


@pytest.mark.parametrize("kind", ["logreg", "worst"])
def test_engine_exact_bregman_falls_back_without_the_form(kind):
    """An oracle without ``bregman_from_aux`` (the base returns None; the
    worst case's aux is None) takes the raw test, as in JAX."""
    f, _, _, _, _ = _engine_case("torch", kind)
    assert f.bregman_from_aux(None, None, None) is None
    rt = _engine("torch", kind, "1.5", exact_bregman=True)
    rr = _engine("torch", kind, "1.5")
    _records_match(rt, _engine("jax", kind, "1.5", exact_bregman=True))
    assert rt.records.gamma.tolist() == rr.records.gamma.tolist()


@pytest.mark.parametrize("nesterov,xi", [(False, 1.0), (False, 2.0), (True, 1.0)])
def test_engine_matches_numpy_mirror(nesterov, xi):
    """The numpy mirror of the reference loop (tests/test_reference_mirror.py)
    on its own inputs: step sizes, residuals and the cumulative trial counts."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((30, 50)), rng.standard_normal(30)
    gamma0 = 10.0 / np.linalg.norm(a, 2) ** 2
    g_np, r_np, f_np, p_np, z_np = np_backtracking(a, b, 0.3, gamma0, 40, xi=xi,
                                                   nesterov=nesterov)
    f, g = apt.lasso_from_numpy(a, b, 0.3, device="cpu", dtype=F64, fused=False)
    solver = apt.backtracking_nesterov if nesterov else functools.partial(
        apt.backtracking_proxgrad, xi=xi)
    res = solver(torch.zeros(50, dtype=F64), f=f, g=g, gamma0=gamma0, tol=0.0, maxit=40,
                 history=True)
    np.testing.assert_allclose(np_of(res.records.gamma), g_np, rtol=1e-7)
    np.testing.assert_allclose(np_of(res.records.norm_res), r_np, rtol=1e-6)
    np.testing.assert_array_equal(np_of(res.records.f_evals), f_np)
    np.testing.assert_array_equal(np_of(res.records.prox_g_evals), p_np)
    np.testing.assert_allclose(np_of(res.x), z_np, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_engine_trial_cap_is_surfaced(side):
    """shrink = 1 and a step 1e6 past stable: every backtrack takes its 101
    evaluations and fails, which the diagnostics latch."""
    f, g, x0, gam, _ = _engine_case(side, "ls")
    mod = ap if side == "jax" else apt
    res = mod.backtracking_proxgrad(x0, f=f, g=g, gamma0=1e6 * gam, shrink=1.0, tol=0.0,
                                    maxit=3, history=True)
    assert bool(res.diag["trials_exhausted"]) and not bool(res.diag["stepsize_underflow"])
    np.testing.assert_array_equal(np_of(res.records.prox_g_evals)[:3], [101, 202, 303])
    np.testing.assert_array_equal(np_of(res.records.f_evals)[:3], [102, 203, 304])


@pytest.mark.parametrize("opt", ["resume_state", "scalar_dtype", "it_cap"])
@pytest.mark.parametrize("solver", ["backtracking_proxgrad", "backtracking_nesterov"])
def test_engine_refuses_what_is_not_ported(solver, opt):
    f, g, x0, gam, _ = _engine_case("torch", "ls")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(apt, solver)(x0, f=f, g=g, gamma0=gam, **{opt: 1})
    with pytest.raises(TypeError, match="torch.Tensor"):
        getattr(apt, solver)(np.zeros(128), f=f, g=g, gamma0=gam)


# -- K4 and K4b, the plain versions -------------------------------------------------------


def _kernel_case(obj):
    """(a, b, gamma0, kwargs) of a kernel case: the lasso (l1), the padded
    logistic [X 1] (l1, m_true 60) or the padded cubic model (zero prox, c 1)."""
    if obj == "ls":
        a, b, gam = _lasso()
        return a, b, gam, dict(prox_kind="l1", p1=1.0)
    if obj == "logreg":
        _, _, a, b, gam = _logistic()
        return a, b, gam, dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=60.0)
    _, _, a, b, gam = _cubic()
    return a, b, gam, dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_k4_plain_matches_jax(obj, nesterov, exact):
    """resident_backtracking against JAX's interpret-mode kernel, tol 0,
    maxit 60 (the cubic model 30: it reaches the f64 noise floor, see the
    module docstring): the four histories (trial counts exactly), the stats
    and x. ``exact_bregman`` changes only "ls" (the other objectives keep the
    raw test, as in JAX)."""
    a, b, gam, kw = _kernel_case(obj)
    n = a.shape[1]
    maxit = 30 if obj == "cubic" else 60
    kw.update(xi=1.5, nesterov=nesterov, record=True, exact_bregman=exact)
    oj = jrb.resident_backtracking(jnp.asarray(a), jnp.asarray(b), jnp.zeros(n), gam, 0.0, maxit,
                                   interpret=True, **kw)
    ot = trb.resident_backtracking(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.zeros(n, dtype=F64), gam, 0.0, maxit, **kw)
    assert int(ot[1]) == int(oj[1]) == maxit
    assert bool(ot[3]) == bool(oj[3]) and bool(ot[4]) == bool(oj[4])
    np.testing.assert_allclose(float(ot[2]), float(oj[2]), rtol=1e-9)
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=1e-9, atol=1e-12)
    for k, name in enumerate(HIST):
        np.testing.assert_allclose(np_of(ot[5 + k]), np_of(oj[5 + k]), rtol=1e-9, err_msg=name)
    np.testing.assert_array_equal(np_of(ot[8]), np_of(oj[8]))
    assert float(ot[8].max()) > 1  # some trial shrank


def test_k4_plain_without_records_and_converged_matches_jax():
    a, b, gam, kw = _kernel_case("ls")
    oj = jrb.resident_backtracking(jnp.asarray(a), jnp.asarray(b), jnp.zeros(128), gam, 1e-6,
                                   2000, xi=2.0, interpret=True, **kw)
    ot = trb.resident_backtracking(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.zeros(128, dtype=F64), gam, 1e-6, 2000, xi=2.0, **kw)
    assert len(ot) == len(oj) == 5
    assert int(ot[1]) == int(oj[1]) < 2000 and bool(ot[3]) and bool(oj[3])
    assert ot[2].dtype == F64 and float(ot[2]) == float(oj[2])  # f32 stats, as JAX's
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=1e-9, atol=1e-12)


def test_k4_zero_iterations_return_x0():
    a, b, gam, kw = _kernel_case("ls")
    x0 = torch.from_numpy(gaussian(3, 128))
    ot = trb.resident_backtracking(torch.from_numpy(a), torch.from_numpy(b), x0, gam, 0.0, 0,
                                   record=True, **kw)
    assert int(ot[1]) == 0 and torch.equal(ot[0], x0) and not bool(ot[3]) and not bool(ot[4])
    assert all(h.shape == (0,) for h in ot[5:])


@pytest.mark.parametrize("nesterov", [False, True])
def test_k4_records_match_jax(nesterov):
    """resident_bt_records against JAX's: the counters from the trial counts,
    on the cubic model solved to tol 1e-6 (rows past numit masked out)."""
    a, b, gam, kw = _kernel_case("cubic")
    ot = trb.resident_backtracking(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.zeros(128, dtype=F64), gam, 1e-6, 80, xi=1.5,
                                   nesterov=nesterov, record=True, **kw)
    rt = apt.resident_bt_records(ot[1], *ot[5:9], maxit=80, nesterov=nesterov)
    rj = jrb.resident_bt_records(int(ot[1]), *(np_of(h) for h in ot[5:9]), maxit=80,
                                 nesterov=nesterov)
    for k in rt._fields:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np.asarray(getattr(rj, k)), k)
    assert int(rt.valid.sum()) == int(ot[1]) < 80


def test_k4_records_match_the_engine():
    """The records K4's histories give equal the engine's, counters and all."""
    for method in ("1.5", "nesterov"):
        res = _engine("torch", "ls", method)
        a, b, gam, kw = _kernel_case("ls")
        ot = trb.resident_backtracking(
            torch.from_numpy(a), torch.from_numpy(b), torch.zeros(128, dtype=F64), gam, 0.0,
            100, xi=1.5, nesterov=method == "nesterov", record=True, **kw)
        recs = apt.resident_bt_records(ot[1], *ot[5:9], maxit=100,
                                       nesterov=method == "nesterov")
        for k in ("gamma", "norm_res", "objective"):
            np.testing.assert_allclose(np_of(getattr(recs, k)), np_of(getattr(res.records, k)),
                                       rtol=1e-9)
        for k in COUNTERS:
            np.testing.assert_array_equal(np_of(getattr(recs, k)),
                                          np_of(getattr(res.records, k)), k)


SWEEP_ROWS = [[1.0, 1.0, 0.0], [1.0, 1.5, 0.0], [1.0, 2.0, 0.0], [1.0, 1.0, 1.0]]


@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_k4b_plain_matches_jax_sweep(obj):
    """resident_bt_sweep against JAX's (tol 1e-7, maxit 60; some rows stop
    early), and each row the same as the single plain call with its
    arguments."""
    a, b, gam, kw = _kernel_case(obj)
    n = a.shape[1]
    rows = np.asarray(SWEEP_ROWS) * [gam, 1, 1]
    oj = jrb.resident_bt_sweep(jnp.asarray(a), jnp.asarray(b), jnp.zeros(n), rows, 1e-7, 60,
                               interpret=True, **kw)
    at, bt, x0 = torch.from_numpy(a), torch.from_numpy(b), torch.zeros(n, dtype=F64)
    ot = trb.resident_bt_sweep(at, bt, x0, rows, 1e-7, 60, **kw)
    for k in range(5):
        np.testing.assert_allclose(np_of(ot[k]).astype(float), np_of(oj[k]).astype(float),
                                   rtol=1e-9, atol=1e-12)
    for k, name in enumerate(HIST):
        np.testing.assert_allclose(np_of(ot[5][k]), np_of(oj[5][k]), rtol=1e-9, err_msg=name)
    for j, (g0, xi, flag) in enumerate(rows):
        one = trb.resident_backtracking(at, bt, x0, g0, 1e-7, 60, xi=xi, nesterov=flag > 0,
                                        record=True, **kw)
        assert all(torch.equal(ot[k][j], one[k]) for k in range(5))
        assert all(torch.equal(ot[5][k][j], one[5 + k]) for k in range(4))


@pytest.mark.parametrize("rows,match", [
    ([[1.0, 1.0]], r"\(R >= 1, 3\)"),
    (np.zeros((0, 3)), r"\(R >= 1, 3\)"),
    ([1.0, 1.0, 0.0], r"\(R >= 1, 3\)"),
    ([[1.0, 1.0, 0.0, 0.0]], r"\(R >= 1, 3\)"),
    ([[1.0, 1.0, 2.0]], "0 or 1"),
    ([[1.0, 1.0, -1.0]], "0 or 1"),
    ([[1.0, 1.0, 0.5]], "0 or 1"),
])
def test_k4b_refuses_bad_rows(rows, match):
    a, b, _, _ = _kernel_case("ls")
    with pytest.raises(ValueError, match=match):
        trb.resident_bt_sweep(torch.from_numpy(a), torch.from_numpy(b),
                              torch.zeros(128, dtype=F64), rows, 0.0, 5)


@pytest.mark.parametrize("entry", ["single", "sweep"])
@pytest.mark.parametrize("kw,exc", [
    (dict(obj_kind="huber"), ValueError), (dict(prox_kind="nuclear"), ValueError),
    (dict(obj_kind="cubic"), ValueError), (dict(maxit=-1), ValueError),
])
def test_k4_refuses_what_it_does_not_take(entry, kw, exc):
    a, b, _, _ = _kernel_case("ls")
    kw = dict(kw)
    maxit = kw.pop("maxit", 5)
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.zeros(128, dtype=F64))
    with pytest.raises(exc):
        if entry == "single":
            trb.resident_backtracking(*args, 0.1, 0.0, maxit, **kw)
        else:
            trb.resident_bt_sweep(*args, SWEEP_ROWS, 0.0, maxit, **kw)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        trb.resident_backtracking(*(t.to("meta") for t in args), 0.1, 0.0, 5)


def test_k4_source_and_build_key():
    """K4 and K4b are built from their own CUDA source for sm_90a, on the
    header K2 shares, with no library kernel standing in."""
    from adaprox_tpu_torch.ops import kernels as tk
    from adaprox_tpu_torch.ops import resident as tr

    src = trb.SOURCE.read_text()
    header = (trb.SOURCE.parent / "resident_common.cuh").read_text()
    assert '#include "resident_common.cuh"' in src and "phase_res" in header
    assert '#include "resident_common.cuh"' in tr.SOURCE.read_text()
    assert "__global__" in src and "adaprox_resident_bt_sweep" in src
    assert "-fmad=false" in trb.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in trb.NVCC_FLAGS
    for banned in ("cublas", "wmma", "mma.sync", "torch", "use_fast_math", "atomicAdd"):
        assert banned not in src.split('#include "resident_common.cuh"', 1)[1]
        assert banned not in header
    assert trb.SOURCE.parent == tk.SOURCE.parent


# -- the lasso driver ---------------------------------------------------------------------


def test_lasso_driver_resident_jsonl_matches_jax(tmp_path, capsys):
    """``--resident`` (the JAX side's kernels in interpret mode): every row,
    aGRAAL's from K4's aGRAAL core included, row for row against JAX's, 20
    iterations as the --fused test."""
    args = ["--sizes", "64x96x8", "--maxit", "20", "--no-plot", "--resident"]
    jlasso.main(["--outdir", str(tmp_path / "jax"), *args])
    tlasso.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    out = capsys.readouterr().out
    assert "skipping rows not ported yet" not in out and "falling back" not in out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "lasso_64_96_8.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "lasso_64_96_8.jsonl")
    assert trows[0] == jrows[0]
    tm = [r for r in trows if "it" in r and r.get("method")]
    jm = [r for r in jrows if "it" in r and r.get("method")]
    assert len(tm) == len(jm) == 9 * 20
    for rj, rt in zip(jm, tm):
        assert list(rt) == list(rj)
        for k, v in rj.items():
            if isinstance(v, float):
                assert rt[k] == pytest.approx(v, rel=1e-9), k
            else:
                assert rt[k] == v, k
    (tgrid, tmeta), (jgrid, jmeta) = trows[-2:], jrows[-2:]
    assert list(tgrid["grid_total_s"]) == list(jgrid["grid_total_s"]) == ["bt sweep",
                                                                         "rule sweep"]
    assert list(tmeta["wall_s"]) == list(jmeta["wall_s"])
    assert tmeta["fast_path"] == jmeta["fast_path"] == "resident"
