"""The Malitsky-Pock slice of the PyTorch port against the JAX package, on the same
numpy inputs (f64 on the CPU unless a test says f32): the engine solver
``malitsky_pock``, the plain version of K6c (the dual-SVM MP t-sweep), its
records, and the large-|f| f32 instance where the exact Bregman form matters.

The JAX side runs K6c in interpret mode, as tests/test_kernels.py does; the
port's wrapper takes its plain version on CPU tensors. The CUDA kernel is tested
on the card (tests/test_torch_cuda.py) and by chip_smoke.py.

About the horizons. The acceptance test compares a difference of near-equal
values, so one ulp of summation order can flip a halving and from there the two
trajectories part. Measured on the CPU in f64, tol 0, the first step size or
residual past rtol 1e-9: the engine against JAX's engine on the ``dsvm`` problem
(40 points, dense Q or factored B, raw and exact form) at iteration 114 to 178
for t = 0.1, 1 and 5 (the counters first differ later still); the plain K6c
against JAX's interpret-mode kernel (128 points, dense and factored, raw and
exact) at iteration 53 (the residual of the t = 2 row; its other rows at 60 or
later, t = 0.05 and 0.5 not in 300). The engine rows are held to rtol 1e-9 over
100 iterations, the kernel's over 50, and every counter and trial count exactly
over the same horizons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of
from test_reference_mirror import np_malitsky_pock
from test_torch_pd import COUNTERS, _close, dsvm_case, pd_kernel_case, t64

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
from adaprox_tpu.models.objectives import FactoredQuadratic as JFQ
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.models.objectives import Quadratic as JQ
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.ops import resident_mp as tm

F64 = torch.float64
ENGINE_HORIZON = 100
KERNEL_HORIZON = 50
TS = [0.05, 0.5, 2.0]


# -- the engine solver ------------------------------------------------------------------------


def _mp_solve(side, t, exact, factored, tol=0.0, maxit=ENGINE_HORIZON, history=True):
    dyx, labels, big_c, norm_a, _ = dsvm_case()
    n = labels.shape[0]
    if side == "jax":
        f = (JFQ(b_mat=jnp.asarray(dyx), q_vec=-jnp.ones(n)) if factored else
             JQ(q_mat=jnp.asarray(dyx @ dyx.T), q_vec=-jnp.ones(n)))
        mod, z, zy = ap, jnp.zeros(n), jnp.zeros(1)
        g, h, a_op = ap.IndBox(lo=0.0, hi=big_c), ap.IndZero(), ap.DenseOperator(
            a=jnp.asarray(labels[None, :]))
    else:
        if factored:
            f, g, h, a_op = apt.dsvm_from_numpy(dyx / labels[:, None], labels, big_c,
                                                device="cpu", dtype=F64)
        else:
            f = apt.quadratic_from_numpy(dyx @ dyx.T, -np.ones(n), device="cpu", dtype=F64)
            g, h, a_op = apt.IndBox(0.0, big_c), apt.IndZero(), apt.DenseOperator(
                t64(labels[None, :]))
        mod, z, zy = apt, torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64)
    return mod.malitsky_pock(z, zy, f=f, g=g, h=h, A=a_op, sigma=1.0 / norm_a, t=t, tol=tol,
                             maxit=maxit, history=history, exact_bregman=exact)


@pytest.mark.parametrize("t", [0.1, 1.0, 5.0])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("factored", [False, True])
def test_mp_engine_rows_match_jax(factored, exact, t):
    """gamma, sigma and norm_res to rtol 1e-9 and all six counters exactly over the
    horizon; the final x, y, counters and the diag flags."""
    rj = _mp_solve("jax", t, exact, factored)
    rt = _mp_solve("torch", t, exact, factored)
    assert rt.numit == int(rj.numit) == ENGINE_HORIZON and rt.name == "MP-ls"
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    assert bool(np_of(rj.records.valid).all()) and len(rt.records.it) == ENGINE_HORIZON
    for k in ("gamma", "sigma", "norm_res"):
        _close(getattr(rt.records, k), getattr(rj.records, k))
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k)), k)
    # the linesearch halved somewhere (the counters are not the trivial schedule)
    assert int(rt.counters.A_evals) > ENGINE_HORIZON + 1
    _close(rt.x, rj.x)
    _close(rt.y, rj.y)
    _close(rt.diag["sigma"], rj.diag["sigma"])
    for k in ("stepsize_underflow", "trials_exhausted"):
        assert bool(rt.diag[k]) == bool(rj.diag[k]) is False
    # the record objective is f + g + h(Ax): h = IndZero is +inf off the constraint
    obj_t, obj_j = np_of(rt.records.objective), np_of(rj.records.objective)
    np.testing.assert_array_equal(np.isinf(obj_t), np.isinf(obj_j))
    fin = ~np.isinf(obj_j)
    np.testing.assert_allclose(obj_t[fin], obj_j[fin], rtol=1e-9)


def test_mp_engine_converges_to_jax_solution():
    """Solved to tol 1e-6 (exact form, t = 1): both stop within 10% of each other's
    iteration count at the same feasible point."""
    rj = _mp_solve("jax", 1.0, True, False, tol=1e-6, maxit=20_000, history=False)
    rt = _mp_solve("torch", 1.0, True, False, tol=1e-6, maxit=20_000, history=False)
    _, labels, big_c, _, _ = dsvm_case()
    assert rt.records is None
    for r in (rj, rt):
        assert int(r.numit) < 20_000 and float(r.norm_res) <= 1e-6
    assert abs(rt.numit - int(rj.numit)) <= 0.1 * int(rj.numit)
    xt, xj = np_of(rt.x), np_of(rj.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6 * np.abs(xj).max())
    assert (xt >= 0).all() and (xt <= big_c).all() and abs(labels @ xt) < 1e-5


def test_mp_engine_matches_numpy_mirror():
    """The reference loop transcribed in numpy (tests/test_reference_mirror.py), with
    sigma0 too large so the halving branch fires: step sizes to rtol 1e-7 over 60
    iterations and the trial counts exactly (cumulative A and f evaluations), as the
    JAX engine is held."""
    rng = np.random.default_rng(11)
    m, n = 40, 64
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    yv = rng.standard_normal(m)
    a_f = rng.standard_normal((20, n)) / np.sqrt(n)
    b_f = rng.standard_normal(20)
    lam, t, iters = 0.05, 1.0, 60
    sigma0 = 2.0 / float(np.linalg.norm(a, 2))
    gam_np, sig_np, trials_np, a_np, f_np, x_np = np_malitsky_pock(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), sigma0, t, iters)
    assert trials_np.max() > 1
    res = apt.malitsky_pock(torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64),
                            f=apt.LeastSquares(t64(a_f), t64(b_f)), g=apt.L1Norm(lam),
                            h=apt.Translate(apt.L2Norm(1.0), -t64(yv)),
                            A=apt.DenseOperator(t64(a)), sigma=sigma0, t=t, tol=0.0,
                            maxit=iters, history=True)
    np.testing.assert_allclose(np_of(res.records.gamma), gam_np, rtol=1e-7)
    np.testing.assert_allclose(np_of(res.records.sigma), sig_np, rtol=1e-7)
    np.testing.assert_array_equal(np_of(res.records.A_evals), a_np)
    np.testing.assert_array_equal(np_of(res.records.f_evals), f_np)
    np.testing.assert_allclose(np_of(res.x), x_np, rtol=1e-6, atol=1e-9)
    # and the JAX engine on the same problem, row for row
    rj = ap.malitsky_pock(jnp.zeros(n), jnp.zeros(m), f=JLS(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
                          g=ap.L1Norm(lam=lam),
                          h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
                          A=ap.DenseOperator(a=jnp.asarray(a)), sigma=sigma0, t=t, tol=0.0,
                          maxit=iters, history=True)
    for k in ("gamma", "sigma", "norm_res"):
        _close(getattr(res.records, k), getattr(rj.records, k))
    for k in COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(res.records, k)),
                                      np_of(getattr(rj.records, k)))


def test_mp_engine_argument_errors():
    dyx, labels, big_c, norm_a, _ = dsvm_case()
    n = labels.shape[0]
    f, g, h, a_op = apt.dsvm_from_numpy(dyx / labels[:, None], labels, big_c, device="cpu",
                                        dtype=F64)
    z, zy = torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64)
    kw = dict(f=f, g=g, h=h, A=a_op)
    for bad in (dict(sigma=0.0), dict(sigma=-1.0), dict(sigma=1.0, t=0.0),
                dict(sigma=1.0, t=-2.0)):
        with pytest.raises(ValueError, match="must be positive"):
            apt.malitsky_pock(z, zy, **kw, **bad)
    for opt, val in (("resume_state", object()), ("scalar_dtype", torch.float64), ("it_cap", 5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            apt.malitsky_pock(z, zy, sigma=1.0, **kw, **{opt: val})
    with pytest.raises(TypeError, match="x0 must be a torch.Tensor"):
        apt.malitsky_pock(np.zeros(n), zy, sigma=1.0, **kw)
    # maxit 0: the start only (one A x0 and one A'y0)
    r = apt.malitsky_pock(z, zy, sigma=1.0 / norm_a, maxit=0, **kw)
    assert r.numit == 0 and tuple(r.counters) == (0, 0, 0, 0, 1, 1)
    assert float(r.norm_res) == float("inf") and torch.equal(r.x, z)


# -- K6c's plain version ----------------------------------------------------------------------


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("n_true", [100, 128])
@pytest.mark.parametrize("factored", [False, True])
def test_k6c_plain_matches_jax(factored, n_true, exact):
    """x, numit, norm_res, converged, ls_failed and the five histories against JAX's
    interpret-mode kernel to rtol 1e-9 over the horizon (the trial counts exactly);
    the padded coordinates stay exactly 0."""
    q, b, lab, n, na, _ = pd_kernel_case()
    n_true = n if n_true == 100 else None
    mat = b if factored else q
    kw = dict(n_true=n_true, record=True, factored=factored, exact_bregman=exact)
    want = jr.resident_mp_dsvm_sweep(jnp.asarray(mat), jnp.asarray(lab), 0.1, jnp.asarray(TS),
                                     1 / na, 0.0, KERNEL_HORIZON, interpret=True, **kw)
    got = tm.resident_mp_dsvm_sweep(t64(mat), t64(lab), 0.1, TS, 1 / na, 0.0, KERNEL_HORIZON,
                                    **kw)
    assert got[1].dtype == torch.int32 and got[3].dtype == got[4].dtype == torch.bool
    assert got[1].tolist() == np_of(want[1]).tolist() == [KERNEL_HORIZON] * 3
    assert got[4].tolist() == np_of(want[4]).tolist() == [False] * 3
    assert len(got[5]) == 5 and all(h.shape == (3, KERNEL_HORIZON) for h in got[5])
    for u, w in zip(got[:4], want[:4]):
        _close(u, w)
    np.testing.assert_array_equal(np_of(got[5][3]), np_of(want[5][3]))  # the trial counts
    assert float(got[5][3].max()) > 1  # the linesearch halved
    for u, w in zip(got[5], want[5]):
        _close(u, w)
    if n_true is not None:
        assert float(got[0][:, n:].abs().max()) == 0.0


def test_k6c_records_match_jax():
    """resident_mp_records rebuilds the counters from the same trial counts as JAX's."""
    q, _, lab, n, na, _ = pd_kernel_case()
    maxit = 40
    want = jr.resident_mp_dsvm_sweep(jnp.asarray(q), jnp.asarray(lab), 0.1, jnp.asarray([0.5]),
                                     1 / na, 1e-3, maxit, n_true=n, record=True, interpret=True)
    hists = tuple(h[0] for h in want[5])
    rj = jr.resident_mp_records(want[1][0], hists, maxit=maxit)
    rt = tm.resident_mp_records(int(want[1][0]), tuple(t64(np.array(h)) for h in hists),
                                maxit=maxit)
    for k in ("it", "valid") + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), k)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), k)


@pytest.mark.parametrize("factored", [False, True])
def test_k6c_records_match_the_engine(factored):
    """As tests/test_kernels.py holds JAX's kernel: the records of the padded plain
    kernel against the engine's on the unpadded problem (FactoredQuadratic, raw form,
    f64): gamma, sigma, norm_res and the counters over the first 10 iterations (the
    knife edge: past them a one-ulp formulation difference may flip a halving), then
    the final objective to rtol 1e-5."""
    q, b, lab, n, na, _ = pd_kernel_case()
    maxit, big_c, ts = 150, 0.1, [0.5, 2.0]
    out = tm.resident_mp_dsvm_sweep(t64(b if factored else q), t64(lab), big_c, ts, 1 / na, 0.0,
                                    maxit, n_true=n, record=True, factored=factored)
    labels = lab[:n]
    f, g, h, a_op = apt.dsvm_from_numpy(b[:n, :9] / labels[:, None], labels, big_c,
                                        device="cpu", dtype=F64)
    for i, t in enumerate(ts):
        recs = tm.resident_mp_records(out[1][i], tuple(hh[i] for hh in out[5]), maxit=maxit)
        ref = apt.malitsky_pock(torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64), f=f, g=g,
                                h=h, A=a_op, sigma=1 / na, t=t, tol=0.0, maxit=maxit,
                                history=True)
        for k in ("gamma", "sigma", "norm_res"):
            _close(getattr(recs, k)[:10], getattr(ref.records, k)[:10], rtol=1e-7)
        for k in ("it",) + COUNTERS:
            np.testing.assert_array_equal(np_of(getattr(recs, k))[:10],
                                          np_of(getattr(ref.records, k))[:10], k)
        _close(recs.objective[-1], f.value(ref.x), rtol=1e-5)
        assert bool(recs.valid.all())


def test_k6c_bf16_storage_matches_jax():
    """bf16 Q (and B) storage with f32 labels: the iterates are f32, and the plain
    version matches JAX's interpret-mode kernel on the same bf16 values over 15
    iterations (trial counts exactly, the rest to 2e-4). At iteration 16 this problem
    has converged: both residuals fall to f32 rounding noise (1e-6), where the two
    summation orders give unrelated values."""
    q, b, lab, n, na, _ = pd_kernel_case(seed=8)
    for mat, factored in ((q, False), (b, True)):
        qj = jnp.asarray(mat, jnp.float32).astype(jnp.bfloat16)
        qt = torch.as_tensor(mat, dtype=torch.float32).to(torch.bfloat16)
        lj, lt = jnp.asarray(lab, jnp.float32), torch.as_tensor(lab, dtype=torch.float32)
        kw = dict(n_true=n, factored=factored, record=True, exact_bregman=True)
        want = jr.resident_mp_dsvm_sweep(qj, lj, 0.1, jnp.asarray([1.0], jnp.float32), 1 / na,
                                         0.0, 15, interpret=True, **kw)
        got = tm.resident_mp_dsvm_sweep(qt, lt, 0.1, [1.0], 1 / na, 0.0, 15, **kw)
        assert got[0].dtype == torch.float32 and got[5][0].dtype == torch.float32
        np.testing.assert_array_equal(np_of(got[5][3]), np_of(want[5][3]))
        for u, w in zip(got[:4] + tuple(got[5]), want[:4] + tuple(want[5])):
            _close(u, w, rtol=2e-4, atol=1e-6)


def test_k6c_large_f_exact_bregman_f32():
    """The large-|f| f32 instance of tests/test_solvers.py (256 points, B 256x16 times 2,
    t 0.15, tol 1e-5, maxit 1500), on the plain version: the exact form's residual is
    below the raw form's tenth, or at tol, as JAX's interpret-mode kernel's is there."""
    rng = np.random.default_rng(1)
    m, d = 256, 16
    bmat = rng.standard_normal((m, d)) * 2.0
    labels = np.where(rng.standard_normal(m) > 0, 1.0, -1.0)
    bmat *= labels[:, None]
    q = torch.as_tensor(np.pad(bmat, ((0, 0), (0, 128 - d))), dtype=torch.float32)
    lab = torch.as_tensor(labels, dtype=torch.float32)
    na = float(np.linalg.norm(labels))
    res = {eb: float(tm.resident_mp_dsvm_sweep(q, lab, 0.1, [0.15], 1 / na, 1e-5, 1500, n_true=m,
                                               factored=True, exact_bregman=eb)[2][0])
           for eb in (True, False)}
    assert res[True] < res[False] / 10 or res[True] <= 1e-5


def test_k6c_entry_validates_before_running():
    q = torch.zeros((128, 128), dtype=F64)
    lab = torch.zeros(128, dtype=F64)
    for sigma0 in (0.0, -1.0):
        with pytest.raises(ValueError, match="must be positive"):
            tm.resident_mp_dsvm_sweep(q, lab, 1.0, [0.5], sigma0, 1e-5, 5)
    for ts in ([], [[0.5, 1.0]], 0.5):
        with pytest.raises(ValueError, match="one dimension"):
            tm.resident_mp_dsvm_sweep(q, lab, 1.0, ts, 0.1, 1e-5, 5)
    with pytest.raises(ValueError, match="square"):
        tm.resident_mp_dsvm_sweep(q[:, :16], lab, 1.0, [0.5], 0.1, 1e-5, 5)
    with pytest.raises(ValueError, match="labels"):
        tm.resident_mp_dsvm_sweep(q[:64], lab, 1.0, [0.5], 0.1, 1e-5, 5, factored=True)
    with pytest.raises(ValueError, match="n_true"):
        tm.resident_mp_dsvm_sweep(q, lab, 1.0, [0.5], 0.1, 1e-5, 5, n_true=129)
    with pytest.raises(ValueError, match="maxit"):
        tm.resident_mp_dsvm_sweep(q, lab, 1.0, [0.5], 0.1, 1e-5, -1)


def test_k6c_zero_iterations_match_jax():
    q, _, lab, n, na, _ = pd_kernel_case()
    want = jr.resident_mp_dsvm_sweep(jnp.asarray(q), jnp.asarray(lab), 0.1, jnp.asarray([1.0]),
                                     1 / na, 0.0, 0, n_true=n, interpret=True)
    got = tm.resident_mp_dsvm_sweep(t64(q), t64(lab), 0.1, [1.0], 1 / na, 0.0, 0, n_true=n)
    assert int(got[1][0]) == int(want[1][0]) == 0 and not bool(got[3][0])
    assert float(got[2][0]) == float(want[2][0]) == float("inf")
    _close(got[0], want[0], rtol=0, atol=0)
