"""The square-root lasso and least-absolute-deviation path of the PyTorch port
against the JAX package, on the same numpy inputs (f64 on the CPU unless a test
says f32): ``ZeroSmooth``, ``L2Norm``, ``IndBall2``, ``Translate`` and the
conjugates, AdaPDM+ (``adaptive_linesearch_primal_dual``), the engine's
Condat-Vu and Malitsky-Pock on the f = 0 problems, the plain version of K7d
(``resident_condat_vu``) and its records, and both drivers' JSONL on both paths.

The JAX side runs K7d in interpret mode, as tests/test_kernels.py does; the
port's wrapper takes its plain version on CPU tensors. The CUDA kernel is
tested on the card (tests/test_torch_cuda.py) and by chip_smoke.py.

About the horizons. Measured on the CPU in f64, tol 0, the first step size,
residual or objective past rtol 1e-9 against JAX: AdaPDM+ on the sqrt-lasso
and LAD problems of tests/test_primal_dual.py (30x10, lam 0.5) never in 400
iterations for t = 0.1 and 1, and at iteration 363 for LAD with t = 5 (its
counters never differed); Malitsky-Pock and Condat-Vu never in 400. The
linesearch rows are held over 300 iterations, the counters exactly over the
same horizon. K7d's plain version agreed with JAX's interpret-mode kernel to
2e-15 over 5000 iterations (128x128, l2 and l1), so it is held to rtol 1e-9
over the whole run. The drivers' 31 rows at maxit 50 agree through all 50, and under
--resident (K7d's and K7a's plain versions against JAX's interpret-mode kernels) at
maxit 60 through all 60. K7a itself is held in tests/test_torch_f0_sweep.py.
"""

import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of
from test_reference_mirror import np_adapdm_plus
from test_torch_pd import COUNTERS, _close, t64

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import least_absolute_deviation as jlad
from adaprox_tpu.experiments import square_root_lasso as jsl
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.ops import resident as jr
from adaprox_tpu.ops.oracles import ZeroSmooth as JZeroSmooth
from adaprox_tpu_torch.experiments import least_absolute_deviation as tlad
from adaprox_tpu_torch.experiments import square_root_lasso as tsl
from adaprox_tpu_torch.ops import resident_f0 as tf
from adaprox_tpu_torch.ops import resident_pd as tpd

F64 = torch.float64
HORIZON = 300
INNERS = ("l2", "l1")
X_ATOL = {"l2": 1e-9, "l1": 1e-5}


# -- the prox pieces ---------------------------------------------------------------------


def _vec(seed=0, n=17):
    v = np.random.default_rng(seed).standard_normal(n) * 2
    v[3] = 0.0
    return v


def _make(mod, name, b):
    return {"l2": lambda: mod.L2Norm(0.7), "ball2": lambda: mod.IndBall2(1.3),
            "translate_l2": lambda: mod.Translate(mod.L2Norm(1.0), b),
            "translate_l1": lambda: mod.Translate(mod.L1Norm(1.0), b),
            "moreau_translate_l2": lambda: mod.MoreauConjugate(mod.Translate(mod.L2Norm(1.0), b)),
            "moreau_translate_l1": lambda: mod.MoreauConjugate(mod.Translate(mod.L1Norm(1.0), b)),
            }[name]()


@pytest.mark.parametrize("name", ["l2", "ball2", "translate_l2", "translate_l1",
                                  "moreau_translate_l2", "moreau_translate_l1"])
def test_prox_and_values_match_jax(name):
    """Value and prox (and the prox's value) against JAX's at rtol 1e-12, for v
    inside and outside the thresholds and v = 0."""
    b = _vec(1)
    fj = _make(ap, name, jnp.asarray(b))
    ft = _make(apt, name, t64(b))
    for scale in (1.0, 0.01, 0.0):
        v = _vec() * scale
        for gamma in (0.3, 2.0):
            yj, vj = fj.prox(jnp.asarray(v), gamma)
            yt, vt = ft.prox(t64(v), gamma)
            np.testing.assert_allclose(np_of(yt), np_of(yj), rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(np_of(vt), np_of(vj), rtol=1e-12, atol=1e-15)
            if not name.startswith("moreau"):
                for x in (v, np_of(yt)):
                    assert float(ft(t64(x))) == pytest.approx(float(fj(jnp.asarray(x))),
                                                              rel=1e-12, abs=1e-15)


def test_conjugates_match_jax():
    """L2Norm(lam) <-> IndBall2(lam) in closed form, Translate by Moreau, as in JAX;
    the conjugates' proxes agree."""
    v = _vec()
    for name in ("l2", "ball2", "translate_l2"):
        cj = ap.conjugate(_make(ap, name, jnp.asarray(_vec(1))))
        ct = apt.conjugate(_make(apt, name, t64(_vec(1))))
        assert type(ct).__name__ == type(cj).__name__
        for gamma in (0.3, 2.0):
            np.testing.assert_allclose(np_of(ct.prox(t64(v), gamma)[0]),
                                       np_of(cj.prox(jnp.asarray(v), gamma)[0]), rtol=1e-12,
                                       atol=1e-15)
    assert isinstance(apt.conjugate(apt.L2Norm(0.7)), apt.IndBall2)
    assert apt.conjugate(apt.IndBall2(1.3)).lam == 1.3
    assert isinstance(apt.conjugate(apt.Translate(apt.L2Norm(), t64(v))), apt.MoreauConjugate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ball2_of_its_own_prox_reads_zero(dtype):
    """The dtype-relative tolerance: the radial projection's recomputed norm may
    overshoot r by a few ulp, and the indicator still reads 0 (in f32 too); a point
    clearly outside reads inf."""
    rng = np.random.default_rng(4)
    ball = apt.IndBall2(0.37)
    for _ in range(50):
        v = torch.as_tensor(rng.standard_normal(257) * 10, dtype=dtype)
        y, val = ball.prox(v, 1.0)
        assert float(ball(y)) == 0.0 and float(val) == 0.0 and y.dtype == dtype
    assert float(ball(torch.full((4,), 1.0, dtype=dtype))) == float("inf")


def test_zero_smooth_matches_jax():
    x = _vec()
    fj, ft = JZeroSmooth(), apt.ZeroSmooth()
    for dt in (F64, torch.float32):
        val, grad = ft.value_and_grad(torch.as_tensor(x, dtype=dt))
        assert val.shape == () and val.dtype == dt and float(val) == 0.0
        assert grad.dtype == dt and not bool(grad.any()) and grad.shape == (17,)
    vj, gj = fj.value_and_grad(jnp.asarray(x))
    assert float(vj) == 0.0 and not np.asarray(gj).any()


# -- the engine on the f = 0 problems ------------------------------------------------------


def sqrt_lasso_case():
    """tests/test_primal_dual.py's sqrt-lasso problem (30 x 10, lam 0.5)."""
    rng = np.random.default_rng(3)
    m, n = 30, 10
    x = rng.standard_normal((m, n))
    y = x @ (rng.standard_normal(n) * (rng.random(n) < 0.5)) + 0.01 * rng.standard_normal(m)
    return x, y, 0.5


def _problem(side, inner):
    x, y, lam = sqrt_lasso_case()
    m, n = x.shape
    if side == "jax":
        a_mat = jnp.asarray(np.hstack([x, np.ones((m, 1))]))
        jin = ap.L2Norm(lam=1.0) if inner == "l2" else ap.L1Norm(lam=1.0)
        parts = (JZeroSmooth(), ap.L1Norm(lam=lam), ap.Translate(inner=jin, b=-jnp.asarray(y)),
                 ap.DenseOperator(a=a_mat))
        return ap, parts, float(jnp.linalg.norm(a_mat)), jnp.zeros(n + 1), jnp.zeros(m)
    f, g, h, a_op, norm_a = apt.sqrt_lasso_from_numpy(x, y, lam, inner, device="cpu", dtype=F64)
    return apt, (f, g, h, a_op), norm_a, torch.zeros(n + 1, dtype=F64), torch.zeros(m, dtype=F64)


def _solve(side, method, inner, t=1.0, tol=0.0, maxit=HORIZON, history=True, **kw):
    mod, (f, g, h, a_op), norm_a, x0, y0 = _problem(side, inner)
    common = dict(f=f, g=g, h=h, A=a_op, tol=tol, maxit=maxit, history=history)
    if method == "adapdm_plus":
        return mod.adaptive_linesearch_primal_dual(x0, y0, eta=norm_a, t=t, **common, **kw)
    if method == "mp":
        return mod.malitsky_pock(x0, y0, sigma=1.0, t=t, **common, **kw)
    return mod.condat_vu(x0, y0, Lf=0.0, norm_A=norm_a, **common, **kw)


def _rows_match(rt, rj, horizon=HORIZON):
    assert rt.numit == int(rj.numit) == horizon
    assert bool(np_of(rj.records.valid).all()) and len(rt.records.it) == horizon
    for k in ("gamma", "sigma", "norm_res", "objective"):
        _close(getattr(rt.records, k), getattr(rj.records, k))
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k)), k)
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    _close(rt.x, rj.x)
    _close(rt.y, rj.y)


@pytest.mark.parametrize("t", [0.1, 1.0, 5.0])
@pytest.mark.parametrize("inner", INNERS)
def test_adapdm_plus_rows_match_jax(inner, t):
    """gamma, sigma, norm_res and the objective to rtol 1e-9, all six counters
    exactly, over the horizon; x, y, eta and the latched flag at its end."""
    rj = _solve("jax", "adapdm_plus", inner, t)
    rt = _solve("torch", "adapdm_plus", inner, t)
    assert rt.name == "AdaPDM+"
    _rows_match(rt, rj)
    _close(rt.diag["eta"], rj.diag["eta"])
    assert bool(rt.diag["trials_exhausted"]) == bool(rj.diag["trials_exhausted"]) is False
    # the warm-up's A'y and one A'y a trial: a trial beyond the first inflated eta
    assert int(rt.counters.At_evals) > HORIZON + 1
    assert int(rt.counters.prox_h_evals) == int(rt.counters.At_evals) - 1


@pytest.mark.parametrize("inner", INNERS)
def test_adapdm_plus_converges_to_jax_solution(inner):
    """Solved to tol (1e-7 for l2, 1e-6 for l1, as tests/test_primal_dual.py): both
    stop within 10% of each other's iteration count at the same x (measured: l2 at
    the same iteration, x to 2e-16 of max |x|; l1 at 7480 and 7404, past the
    horizon, x to 6e-7)."""
    tol = 1e-7 if inner == "l2" else 1e-6
    rj = _solve("jax", "adapdm_plus", inner, tol=tol, maxit=50_000, history=False)
    rt = _solve("torch", "adapdm_plus", inner, tol=tol, maxit=50_000, history=False)
    assert rt.records is None and rt.numit < 50_000 and float(rt.norm_res) <= tol
    assert abs(rt.numit - int(rj.numit)) <= 0.1 * int(rj.numit)
    xt, xj = np_of(rt.x), np_of(rj.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=X_ATOL[inner] * np.abs(xj).max())
    # the objective matches Condat-Vu's at the same tol (tests/test_primal_dual.py)
    cv = _solve("torch", "cv", inner, tol=tol, maxit=50_000, history=False)
    _, (_, g, h, a_op), _, _, _ = _problem("torch", inner)
    obj = [float(g(r.x) + h(a_op.matvec(r.x))) for r in (rt, cv)]
    assert obj[0] == pytest.approx(obj[1], abs=1e-5 if inner == "l2" else 1e-4)


def test_adapdm_plus_returns_the_checked_iterate():
    """Converged at iteration k, the solve returns the x of the check (the x after
    k - 1 second halves: a run capped at k - 1 returns it) and the check's counters."""
    r = _solve("torch", "adapdm_plus", "l2", tol=1e-6, maxit=50_000, history=True)
    capped = _solve("torch", "adapdm_plus", "l2", tol=0.0, maxit=r.numit - 1, history=False)
    assert bool(r.records.norm_res[-1] <= 1e-6) and torch.equal(r.x, capped.x)
    last = r.records
    assert tuple(r.counters) == tuple(int(getattr(last, k)[-1]) for k in COUNTERS)


def test_adapdm_plus_argument_errors():
    mod, (f, g, h, a_op), norm_a, x0, y0 = _problem("torch", "l2")
    kw = dict(f=f, g=g, h=h, A=a_op)
    for bad in (dict(eta=0.0), dict(eta=-1.0), dict(t=0.0), dict(t=-2.0)):
        with pytest.raises(ValueError, match="must be positive"):
            apt.adaptive_linesearch_primal_dual(x0, y0, **kw, **bad)
    for theta, delta in ((1.0, 1e-8), (1.5, 0.5)):
        with pytest.raises(ValueError, match="Theta > delta"):
            apt.adaptive_linesearch_primal_dual(x0, y0, Theta=theta, delta=delta, **kw)
        with pytest.raises(ValueError, match="Theta > delta"):
            ap.adaptive_linesearch_primal_dual(jnp.zeros(11), jnp.zeros(30), f=JZeroSmooth(),
                                               g=ap.L1Norm(lam=0.5), h=ap.L2Norm(),
                                               A=ap.DenseOperator(a=jnp.zeros((30, 11))),
                                               Theta=theta, delta=delta)
    bound = 1.0 / (2 * 1.2 * 1.0 * norm_a)
    with pytest.raises(ValueError, match="gamma is too large"):
        apt.adaptive_linesearch_primal_dual(x0, y0, eta=norm_a, gamma=1.01 * bound, **kw)
    apt.adaptive_linesearch_primal_dual(x0, y0, eta=norm_a, gamma=bound, maxit=2, **kw)
    for opt, val in (("resume_state", object()), ("scalar_dtype", F64), ("it_cap", 5)):
        with pytest.raises(NotImplementedError, match="Engine behaviours still to port"):
            apt.adaptive_linesearch_primal_dual(x0, y0, **{opt: val}, **kw)
    with pytest.raises(TypeError, match="x0 must be a torch.Tensor"):
        apt.adaptive_linesearch_primal_dual(np.zeros(11), y0, **kw)
    # maxit 0: the warm-up only (A x0, f, grad f, A'y0 and one prox_g)
    r = apt.adaptive_linesearch_primal_dual(x0, y0, eta=norm_a, maxit=0, **kw)
    assert r.numit == 0 and tuple(r.counters) == (1, 1, 1, 0, 1, 1)
    assert float(r.norm_res) == float("inf") and r.diag["eta"] == norm_a


@pytest.mark.parametrize("eta_frac", [1.0, 0.3])
def test_adapdm_plus_matches_numpy_mirror(eta_frac):
    """The reference loop transcribed in numpy (tests/test_reference_mirror.py), with
    f = least squares; eta_frac < 1 underestimates ||A||, so the inflation fires:
    gamma and sigma to rtol 1e-7, the trial counts (cumulative At_evals) exactly, eta
    and x, as the JAX engine is held; and the JAX engine row for row."""
    rng = np.random.default_rng(7)
    m, n = 40, 64
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    yv = rng.standard_normal(m)
    a_f = rng.standard_normal((20, n)) / np.sqrt(n)
    b_f = rng.standard_normal(20)
    lam, t, iters = 0.05, 1.0, 60
    eta0 = eta_frac * float(np.linalg.norm(a, 2))
    gam_np, sig_np, eta_np, trials_np, at_np, x_np = np_adapdm_plus(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), eta0, t, iters)
    assert trials_np.max() > 1 or eta_frac == 1.0
    res = apt.adaptive_linesearch_primal_dual(
        torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64),
        f=apt.LeastSquares(t64(a_f), t64(b_f)), g=apt.L1Norm(lam),
        h=apt.Translate(apt.L2Norm(1.0), -t64(yv)), A=apt.DenseOperator(t64(a)), eta=eta0, t=t,
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np_of(res.records.gamma), gam_np, rtol=1e-7)
    np.testing.assert_allclose(np_of(res.records.sigma), sig_np, rtol=1e-7)
    np.testing.assert_array_equal(np_of(res.records.At_evals), at_np)
    np.testing.assert_allclose(float(res.diag["eta"]), eta_np[-1], rtol=1e-7)
    np.testing.assert_allclose(np_of(res.x), x_np, rtol=1e-6, atol=1e-9)
    rj = ap.adaptive_linesearch_primal_dual(
        jnp.zeros(n), jnp.zeros(m), f=JLS(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
        g=ap.L1Norm(lam=lam), h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
        A=ap.DenseOperator(a=jnp.asarray(a)), eta=eta0, t=t, tol=0.0, maxit=iters, history=True)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        _close(getattr(res.records, k), getattr(rj.records, k))
    for k in COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(res.records, k)),
                                      np_of(getattr(rj.records, k)))


@pytest.mark.parametrize("method", ["cv", "mp"])
@pytest.mark.parametrize("inner", INNERS)
def test_engine_condat_vu_and_malitsky_pock_match_jax(inner, method):
    """The engine's Condat-Vu and Malitsky-Pock (t = 1, sigma0 = 1) with ZeroSmooth and
    Translate: the rows to rtol 1e-9 and the counters exactly over the horizon."""
    rj = _solve("jax", method, inner)
    rt = _solve("torch", method, inner)
    _rows_match(rt, rj)


# -- K7d's plain version ---------------------------------------------------------------------


def k7d_case(m=128, n=128, seed=9):
    """tests/test_kernels.py's K7d problem: A (m, n) Gaussian, bv = A w + noise with a
    sparse w, lam 1, the Condat-Vu steps from the Frobenius norm (Lf = 0)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    w_true = rng.standard_normal(n) * (rng.random(n) < 0.2)
    bv = a @ w_true + 0.1 * rng.standard_normal(m)
    na = float(np.linalg.norm(a))
    return a, bv, 1.0, 1.0 / na, 0.99 / na


@pytest.mark.parametrize("tol,maxit", [(0.0, 80), (1e-6, 5000)])
@pytest.mark.parametrize("h_kind", INNERS)
def test_k7d_plain_matches_jax(h_kind, tol, maxit):
    """x, numit, norm_res, converged and the (norm_res, objective) histories against
    JAX's interpret-mode kernel: numit and converged equal, the rest to rtol 1e-9;
    the records' counters equal JAX's resident_cv_records."""
    a, bv, lam, gamma, sigma = k7d_case()
    want = jr.resident_condat_vu(jnp.asarray(a), jnp.asarray(bv), lam, gamma, sigma, tol, maxit,
                                 record=True, h_kind=h_kind, interpret=True)
    got = tf.resident_condat_vu(t64(a), t64(bv), lam, gamma, sigma, tol, maxit, record=True,
                                h_kind=h_kind)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool
    assert int(got[1]) == int(want[1]) and bool(got[3]) == bool(want[3])
    assert got[4][0].shape == got[4][1].shape == (maxit,)
    for u, w in zip(got[:3] + tuple(got[4]), want[:3] + tuple(want[4])):
        _close(u, w)
    rj = jr.resident_cv_records(want[1], gamma, sigma, want[4], maxit=maxit)
    rt = tpd.resident_cv_records(got[1], gamma, sigma, got[4], maxit=maxit)
    for k in ("it", "valid") + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), k)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        _close(getattr(rt, k), getattr(rj, k))
    if tol > 0 and h_kind == "l2":
        assert bool(got[3]) and int(got[1]) < maxit


@pytest.mark.parametrize("h_kind", INNERS)
def test_k7d_records_match_the_engine(h_kind):
    """As tests/test_kernels.py holds JAX's kernel: the records of the plain K7d
    against the engine's condat_vu on the same problem, row for row."""
    a, bv, lam, gamma, sigma = k7d_case()
    maxit = 80
    out = tf.resident_condat_vu(t64(a), t64(bv), lam, gamma, sigma, 0.0, maxit, record=True,
                                h_kind=h_kind)
    recs = tpd.resident_cv_records(out[1], gamma, sigma, out[4], maxit=maxit)
    inner = apt.L2Norm(1.0) if h_kind == "l2" else apt.L1Norm(1.0)
    ref = apt.condat_vu(torch.zeros(128, dtype=F64), torch.zeros(128, dtype=F64),
                        f=apt.ZeroSmooth(), g=apt.L1Norm(lam), h=apt.Translate(inner, -t64(bv)),
                        A=apt.DenseOperator(t64(a)), Lf=0.0, norm_A=float(np.linalg.norm(a)),
                        tol=0.0, maxit=maxit, history=True)
    for k in ("norm_res", "objective"):
        _close(getattr(recs, k), getattr(ref.records, k))
    for k in COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(recs, k)), np_of(getattr(ref.records, k)))
    _close(out[0], ref.x)


@pytest.mark.parametrize("h_kind", INNERS)
def test_k7d_padding_is_exact(h_kind):
    """A 100 x 90 problem zero-padded to 128 x 128 (A and bv), as the drivers pad: the
    padded coordinates of x stay exactly 0, and the solve equals the unpadded one
    (numit, converged; x, norm_res and the histories to rtol 1e-12)."""
    a, bv, lam, gamma, sigma = k7d_case(100, 90, seed=2)
    a_pad, bv_pad = np.zeros((128, 128)), np.zeros(128)
    a_pad[:100, :90], bv_pad[:100] = a, bv
    kw = dict(record=True, h_kind=h_kind)
    for tol, maxit in ((0.0, 200), (1e-6, 5000)):
        got = tf.resident_condat_vu(t64(a_pad), t64(bv_pad), lam, gamma, sigma, tol, maxit, **kw)
        want = tf.resident_condat_vu(t64(a), t64(bv), lam, gamma, sigma, tol, maxit, **kw)
        assert not bool(got[0][90:].any())
        assert int(got[1]) == int(want[1]) and bool(got[3]) == bool(want[3])
        _close(got[0][:90], want[0], rtol=1e-12, atol=1e-14)
        for u, w in zip((got[2],) + tuple(got[4]), (want[2],) + tuple(want[4])):
            _close(u, w, rtol=1e-12, atol=1e-14)


def test_k7d_bf16_storage_matches_jax():
    """bf16 A with an f32 bv: the iterates are f32, and the plain version matches JAX's
    interpret-mode kernel on the same bf16 values to 1e-5 over 200 iterations (the
    fixed steps contract the two summation orders' f32 rounding)."""
    a, bv, lam, gamma, sigma = k7d_case()
    aj = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    at = torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)
    bj, bt = jnp.asarray(bv, jnp.float32), torch.as_tensor(bv, dtype=torch.float32)
    for h_kind in INNERS:
        want = jr.resident_condat_vu(aj, bj, lam, gamma, sigma, 0.0, 200, record=True,
                                     h_kind=h_kind, interpret=True)
        got = tf.resident_condat_vu(at, bt, lam, gamma, sigma, 0.0, 200, record=True,
                                    h_kind=h_kind)
        assert got[0].dtype == got[4][0].dtype == torch.float32
        for u, w in zip(got[4], want[4]):
            _close(u, w, rtol=1e-5, atol=0)
        _close(got[0], want[0], rtol=1e-5, atol=1e-5 * float(np.abs(np_of(want[0])).max()))


def test_k7d_zero_iterations_match_jax():
    a, bv, lam, gamma, sigma = k7d_case()
    want = jr.resident_condat_vu(jnp.asarray(a), jnp.asarray(bv), lam, gamma, sigma, 0.0, 0,
                                 interpret=True)
    got = tf.resident_condat_vu(t64(a), t64(bv), lam, gamma, sigma, 0.0, 0)
    assert int(got[1]) == int(want[1]) == 0 and not bool(got[3])
    assert float(got[2]) == float(want[2]) == float("inf")
    _close(got[0], want[0], rtol=0, atol=0)


def test_k7d_entry_validates_before_running():
    a, bv = torch.zeros((128, 64), dtype=F64), torch.zeros(128, dtype=F64)
    with pytest.raises(ValueError, match="h_kind"):
        tf.resident_condat_vu(a, bv, 1.0, 0.1, 0.1, 1e-5, 5, h_kind="linf")
    with pytest.raises(ValueError, match="need a"):
        tf.resident_condat_vu(a, bv[:64], 1.0, 0.1, 0.1, 1e-5, 5)
    with pytest.raises(ValueError, match="need a"):
        tf.resident_condat_vu(a[0], bv, 1.0, 0.1, 0.1, 1e-5, 5)
    with pytest.raises(ValueError, match="maxit"):
        tf.resident_condat_vu(a, bv, 1.0, 0.1, 0.1, 1e-5, -1)
    with pytest.raises(ValueError, match="CPU .plain version. or CUDA"):
        tf.resident_condat_vu(a.to("meta"), bv.to("meta"), 1.0, 0.1, 0.1, 1e-5, 5)


# -- the drivers -----------------------------------------------------------------------------


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


DRIVER_NAMES = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in tsl.T_VALUES]
                + [f"AdaPDM+ (t={t})" for t in tsl.T_VALUES])
DRIVERS = {"sqrt_lasso": (jsl, tsl), "lad": (jlad, tlad)}


def _driver_rows(tmp_path, capsys, which, extra, maxit=50):
    jmod, tmod = DRIVERS[which]
    args = ["--datasets", "housing_scale", "--maxit", str(maxit), "--no-plot", *extra]
    jmod.main(["--cpu", "--f64", "--outdir", str(tmp_path / "jax"), *args])
    capsys.readouterr()
    tmod.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    out = capsys.readouterr().out
    rows = [tlog.read_jsonl(tmp_path / side / "housing_scale.jsonl") for side in ("jax", "torch")]
    by = []
    for side_rows in rows:
        d = {}
        for r in side_rows:
            if "norm_res" in r:
                d.setdefault(r["method"], []).append(r)
        by.append(d)
    return rows, by, out


@pytest.mark.parametrize("which", ["sqrt_lasso", "lad"])
def test_driver_jsonl_matches_jax(tmp_path, capsys, no_download, which):
    """housing_scale's stand-in (506 x 13, [X 1] 506 x 14), maxit 50, f64, against the
    JAX driver's --cpu --f64 JSONL: the 31 rows in JAX's order and names, KEYS, the
    counters row by row and norm_res to rtol 1e-9, and the meta rows' keys."""
    (jrows, trows), (jby, tby), out = _driver_rows(tmp_path, capsys, which, [])
    assert "not ported" not in out and "skipped" not in out
    assert list(tby) == list(jby) == DRIVER_NAMES
    for name in DRIVER_NAMES:
        rows, want = tby[name], jby[name]
        assert len(rows) == len(want) == 50, name
        for rt, rj in zip(rows, want):
            assert list(rt) == list(rj) == tsl.KEYS
            assert (rt["method"], rt["A_evals"], rt["At_evals"]) == (
                rj["method"], rj["A_evals"], rj["At_evals"]), name
            assert rt["norm_res"] == pytest.approx(rj["norm_res"], rel=1e-9), name
    # the AdaPDM+ linesearch inflated eta somewhere: At_evals is not 1 + it
    assert max(r["At_evals"] - len(tby[n_]) - 1 for n_ in DRIVER_NAMES if "+" in n_
               for r in tby[n_][-1:]) > 0
    tmeta = [r for r in trows if "norm_res" not in r]
    jmeta = [r for r in jrows if "norm_res" not in r]
    assert [list(r) for r in tmeta] == [list(r) for r in jmeta] == [
        ["wall_s", "fast_path", "fast_methods"], ["data_source"]]
    assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"]) == [
        "Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
    assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == "default"
    assert tmeta[0]["fast_methods"] == jmeta[0]["fast_methods"] == []
    assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}


@pytest.mark.parametrize("which", ["sqrt_lasso", "lad"])
def test_driver_resident_condat_vu_row_matches_jax(tmp_path, capsys, no_download, which):
    """--resident at --maxit 60: all 31 rows from the three kernels' plain versions (K7d,
    K7a's MP and AdaPDM+ cores) on the 128-padded A against JAX's --resident rows (its
    interpret-mode kernels), in JAX's order and names: the counters row by row exactly
    and norm_res to rel 1e-9 over all 60 iterations; no row is skipped, and the meta
    row's fast_methods and wall_s keys are JAX's."""
    (jrows, trows), (jby, tby), out = _driver_rows(tmp_path, capsys, which, ["--resident"],
                                                   maxit=60)
    assert "skipped" not in out and "not ported" not in out
    assert list(tby) == list(jby) == DRIVER_NAMES
    for name in DRIVER_NAMES:
        for rt, rj in zip(tby[name], jby[name], strict=True):
            assert list(rt) == tsl.KEYS
            assert (rt["method"], rt["A_evals"], rt["At_evals"]) == (
                rj["method"], rj["A_evals"], rj["At_evals"]), name
            assert rt["norm_res"] == pytest.approx(rj["norm_res"], rel=1e-9), name
        assert len(tby[name]) == 60, name
    tmeta = [r for r in trows if "norm_res" not in r]
    jmeta = [r for r in jrows if "norm_res" not in r]
    assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == "resident"
    assert tmeta[0]["fast_methods"] == jmeta[0]["fast_methods"] == tsl.FAST_METHODS == [
        "Condat-Vu", "Malitsky-Pock t-sweep", "AdaPDM+ t-sweep"]
    assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"]) == tsl.FAST_METHODS


def test_driver_resident_routing_limit_falls_back(tmp_path, capsys, monkeypatch):
    """Past the routing limit (24 MiB a layout, the JAX driver's) --resident runs the
    engine, as the JAX driver does."""
    monkeypatch.setattr(tsl, "_VMEM_BYTES", 1024)
    tsl.main(["--outdir", str(tmp_path), "--device", "cpu", "--datasets", "housing_scale",
              "--maxit", "3", "--no-plot", "--resident"])
    assert "exceeds the routing limit; falling back to the engine" in capsys.readouterr().out
    rows = tlog.read_jsonl(tmp_path / "housing_scale.jsonl")
    assert len({r["method"] for r in rows if "norm_res" in r}) == 31
    assert rows[-2]["fast_path"] == "default"


def test_driver_refuses_cuda_without_a_card(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlad.main(["--outdir", str(tmp_path), "--datasets", "housing_scale", "--no-plot"])


def test_driver_says_which_flags_are_not_offered(capsys):
    with pytest.raises(SystemExit):
        tsl.main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "--vmap-sweep and --live are not offered yet" in out
    assert "--resident-grid" in out and "one K7c launch" in out
    assert "--fused" in out and "K5" in out
