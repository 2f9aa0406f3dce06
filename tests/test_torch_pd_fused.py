"""The fused primal-dual path of the port (``ops/pd_kernels.py``: K5's plain version;
``solvers/pd_fused.py``; ``ElasticNet``, ``PadTail`` and ``PadDomain``; the f = 0 drivers'
``--fused``) against the JAX package's on the CPU, in float64 unless a test says
otherwise. The JAX side runs as ``tests/test_pd_fused.py`` runs it: K5 in interpret mode,
chosen automatically on the CPU. Inputs come from a numpy seed and reach both sides as
numpy arrays.
"""

import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import least_absolute_deviation as jlad
from adaprox_tpu.experiments import square_root_lasso as jsl
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.models.synthetic import random_lasso
from adaprox_tpu.ops import oracles as joracles
from adaprox_tpu.ops import pd_kernels as jpk
from adaprox_tpu.solvers import pd_fused as jpf
from adaprox_tpu_torch.experiments import least_absolute_deviation as tlad
from adaprox_tpu_torch.experiments import square_root_lasso as tsl
from adaprox_tpu_torch.ops import pd_kernels as tpk
from adaprox_tpu_torch.solvers import pd_fused as tpf

F64 = torch.float64
MENU = [("l1", 0.7, 0.0), ("box", -0.5, 0.5), ("elastic", 0.3, 0.2), ("zero", 0.0, 0.0)]


def t64(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def _vec(seed, n):
    return np.random.default_rng(seed).standard_normal(n)


# -- ElasticNet, PadTail, PadDomain ------------------------------------------------------


def test_elastic_net_matches_jax():
    """Value, prox and the Moreau conjugate's prox, with a NaN and exact zeros in v:
    rtol 1e-15 (the same operations in the same order), NaN where JAX has NaN."""
    v = _vec(1, 33)
    v[3], v[4] = np.nan, 0.0
    j, t = ap.ElasticNet(lam1=0.4, lam2=0.7), apt.ElasticNet(0.4, 0.7)
    for gamma in (0.3, 2.0):
        (yj, vj), (yt, vt) = j.prox(jnp.asarray(v), gamma), t.prox(t64(v), gamma)
        np.testing.assert_allclose(np_of(yt), np.asarray(yj), rtol=1e-15, atol=0)
        assert np.isnan(float(vt)) and np.isnan(float(vj))  # the NaN reaches the value
        cj = ap.conjugate(j).prox(jnp.asarray(v), gamma)[0]
        ct = apt.conjugate(t).prox(t64(v), gamma)[0]
        np.testing.assert_allclose(np_of(ct), np.asarray(cj), rtol=1e-15, atol=1e-15)
    w = np.nan_to_num(v)
    assert float(t(t64(w))) == pytest.approx(float(j(jnp.asarray(w))), rel=1e-15)
    assert isinstance(apt.conjugate(t), apt.MoreauConjugate)


@pytest.mark.parametrize("inner", ["l2", "l1"])
def test_pad_tail_matches_jax(inner):
    """PadTail(Translate(inner, -b), m_true = 10) on a 16-vector: its value reads only the
    head, its prox passes the tail through, and its conjugate's prox pins the tail to
    exactly 0; head values to rtol 1e-14 of JAX's."""
    b, z = _vec(2, 10), _vec(3, 16)
    jin = ap.L2Norm(lam=1.0) if inner == "l2" else ap.L1Norm(lam=1.0)
    tin = apt.L2Norm(1.0) if inner == "l2" else apt.L1Norm(1.0)
    j = ap.PadTail(ap.Translate(inner=jin, b=-jnp.asarray(b)), 10)
    t = apt.PadTail(apt.Translate(tin, -t64(b)), 10)
    assert float(t(t64(z))) == pytest.approx(float(j(jnp.asarray(z))), rel=1e-14)
    for sigma in (0.5, 3.0):
        pj, pt = j.prox(jnp.asarray(z), sigma)[0], t.prox(t64(z), sigma)[0]
        np.testing.assert_allclose(np_of(pt), np.asarray(pj), rtol=1e-14, atol=1e-14)
        assert torch.equal(pt[10:], t64(z)[10:])
        cj = ap.conjugate(j).prox(jnp.asarray(z), sigma)[0]
        ct = apt.conjugate(t).prox(t64(z), sigma)[0]
        np.testing.assert_allclose(np_of(ct), np.asarray(cj), rtol=1e-14, atol=1e-14)
        assert bool((ct[10:] == 0).all()) and np.all(np.asarray(cj)[10:] == 0)


@pytest.mark.parametrize("smooth", ["least_squares", "zero"])
def test_pad_domain_matches_jax(smooth):
    """PadDomain(f, n_true = 13) on a 16-vector: the value of the head, the head gradient
    to rtol 1e-14 of JAX's and a tail of exact zeros."""
    x = _vec(4, 16)
    if smooth == "zero":
        jf, tf = joracles.ZeroSmooth(), apt.ZeroSmooth()
    else:
        a, b = np.random.default_rng(5).standard_normal((9, 13)), _vec(6, 9)
        jf, tf = JLS(a=jnp.asarray(a), b=jnp.asarray(b)), apt.LeastSquares(t64(a), t64(b))
    j, t = joracles.PadDomain(jf, 13), apt.PadDomain(tf, 13)
    fj, gj = j.value_and_grad(jnp.asarray(x))
    ft, gt = t.value_and_grad(t64(x))
    assert float(ft) == pytest.approx(float(fj), rel=1e-14, abs=0)
    np.testing.assert_allclose(np_of(gt), np.asarray(gj), rtol=1e-14, atol=1e-14)
    assert bool((gt[13:] == 0).all())


# -- K5's plain version ----------------------------------------------------------------


@pytest.fixture(scope="module")
def srl_problem():
    """tests/test_pd_fused.py's square-root-lasso problem: random_lasso(64, 256, 8,
    seed 11), h = Translate(L2Norm(1), -b), f = 0, g = 10 ||.||_1."""
    prob = random_lasso(m=64, n=256, pfactor=8, seed=11)
    return np.asarray(prob.a, dtype=np.float64), np.asarray(prob.b, dtype=np.float64)


def _k5_inputs(seed, n, m):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(m), rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("kind,p1,p2", MENU)
def test_k5_plain_matches_jax_interpret(srl_problem, kind, p1, p2):
    """pd_primal_update_plain on A' 256 x 64 against JAX's interpret-mode kernel and its
    XLA version, each prox kind: rtol 1e-10, atol 1e-12 (tests/test_pd_fused.py's)."""
    a, _ = srl_problem
    at = a.T.copy()
    y, x, grad = _k5_inputs(0, *at.shape)
    ji = jpk.fused_pd_primal_update(jnp.asarray(at), jnp.asarray(y), jnp.asarray(x),
                                    jnp.asarray(grad), 0.01, p1, p2, prox_kind=kind,
                                    interpret=True)
    jx = jpk.pd_primal_update_xla(jnp.asarray(at), jnp.asarray(y), jnp.asarray(x),
                                  jnp.asarray(grad), 0.01, p1, p2, prox_kind=kind)
    got = tpk.fused_pd_primal_update(t64(at), t64(y), t64(x), t64(grad), 0.01, p1, p2,
                                     prox_kind=kind)
    plain = tpk.pd_primal_update_plain(t64(at), t64(y), t64(x), t64(grad), 0.01, p1, p2,
                                       prox_kind=kind)
    for g_, p_, r_i, r_x in zip(got, plain, ji, jx):
        assert torch.equal(g_, p_)  # on the CPU the entry is the plain version
        np.testing.assert_allclose(np_of(g_), np.asarray(r_i), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np_of(g_), np.asarray(r_x), rtol=1e-10, atol=1e-12)


def test_k5_plain_bf16_storage_matches_jax(srl_problem):
    """bf16-stored A' with f32 vectors: both sides upcast the same bf16 values and sum in
    f32 in different orders, so each output within 1e-5 of its largest magnitude."""
    a, _ = srl_problem
    at = a.T.copy()
    y, x, grad = (v.astype(np.float32) for v in _k5_inputs(1, *at.shape))
    at16 = jnp.asarray(at, jnp.float32).astype(jnp.bfloat16)
    ji = jpk.fused_pd_primal_update(at16, jnp.asarray(y), jnp.asarray(x), jnp.asarray(grad),
                                    0.01, 0.7, 0.0, prox_kind="l1", interpret=True)
    got = tpk.fused_pd_primal_update(
        torch.as_tensor(at, dtype=torch.float32).to(torch.bfloat16), torch.as_tensor(y),
        torch.as_tensor(x), torch.as_tensor(grad), 0.01, 0.7, 0.0, prox_kind="l1")
    for g_, r_ in zip(got, ji):
        assert g_.dtype == torch.float32
        r_ = np.asarray(r_)
        assert np.abs(np_of(g_) - r_).max() <= 1e-5 * np.abs(r_).max()


def test_k5_nan_semantics_match_jax():
    """A NaN in x: NaN at its x_new for every prox kind (jnp.sign, maximum and clip
    propagate it) and in all of A x_new, where JAX's interpret-mode kernel has them; a
    zero v gives an exact 0."""
    y, x, grad = _k5_inputs(2, 16, 128)
    at = np.random.default_rng(3).standard_normal((16, 128))
    x[5], y[:] = np.nan, 0.0
    x[7] = grad[7] = 0.0
    for kind, p1, p2 in MENU:
        ji = jpk.fused_pd_primal_update(jnp.asarray(at), jnp.asarray(y), jnp.asarray(x),
                                        jnp.asarray(grad), 0.5, p1, p2, prox_kind=kind,
                                        interpret=True)
        got = tpk.fused_pd_primal_update(t64(at), t64(y), t64(x), t64(grad), 0.5, p1, p2,
                                         prox_kind=kind)
        for g_, r_ in zip(got, ji):
            assert np.array_equal(np.isnan(np_of(g_)), np.isnan(np.asarray(r_))), kind
        assert np.isnan(float(got[2][5])) and bool(torch.isnan(got[3]).all())
        assert float(got[2][7]) == 0.0


def test_k5_refuses_what_jax_interpret_refuses():
    """n off the row-tile rule (n % 8, % 16 for bf16 storage) is refused on both sides in
    interpret mode; an m off the 128 lanes is taken, as JAX's interpret mode takes it; a
    prox outside the menu and mismatched shapes raise."""
    y, x, grad = _k5_inputs(4, 100, 64)
    at = np.random.default_rng(5).standard_normal((100, 64))
    with pytest.raises(ValueError, match="not divisible"):
        jpk.fused_pd_primal_update(jnp.asarray(at), jnp.asarray(y), jnp.asarray(x),
                                   jnp.asarray(grad), 0.1, 0.5, prox_kind="l1",
                                   interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        tpk.fused_pd_primal_update(t64(at), t64(y), t64(x), t64(grad), 0.1, 0.5)
    at16 = torch.zeros(8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        tpk.fused_pd_primal_update(at16, torch.zeros(64), torch.zeros(8), torch.zeros(8), 0.1)
    assert not tpk.pd_fusable(at16) and not tpk.pd_fusable(t64(at))
    assert tpk.pd_fusable(torch.zeros(16, 128, dtype=torch.bfloat16))
    assert tpk.pd_fusable(torch.zeros(8, 128)) and not tpk.pd_fusable(torch.zeros(8, 64))
    # m = 64: taken on both sides
    tpk.fused_pd_primal_update(t64(at[:96]), t64(y), t64(x[:96]), t64(grad[:96]), 0.1, 0.5)
    with pytest.raises(ValueError, match="prox_kind"):
        tpk.fused_pd_primal_update(t64(at[:96]), t64(y), t64(x[:96]), t64(grad[:96]), 0.1,
                                   prox_kind="l2")
    with pytest.raises(ValueError, match="shape mismatch"):
        tpk.fused_pd_primal_update(t64(at[:96]), t64(y[:63]), t64(x[:96]), t64(grad[:96]), 0.1)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        tpk.fused_pd_primal_update(t64(at[:96]).to("meta"), t64(y).to("meta"),
                                   t64(x[:96]).to("meta"), t64(grad[:96]).to("meta"), 0.1)


# -- the fused solvers -------------------------------------------------------------------


def _srl(srl_problem, side):
    a, b = srl_problem
    if side == "jax":
        h = ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(b))
        return jnp.asarray(a), h, ap.ZeroSmooth(), ap.L1Norm(lam=10.0)
    h = apt.Translate(apt.L2Norm(1.0), -t64(b))
    return t64(a), h, apt.ZeroSmooth(), apt.L1Norm(10.0)


def _assert_counters_equal(rt, rj):
    for k in rt.counters._fields:
        assert int(getattr(rt.counters, k)) == int(getattr(rj.counters, k)), k


def test_fused_adapdm_matches_jax(srl_problem):
    """fused_adaptive_primal_dual to tol 1e-9 (maxit 400) against JAX's: numit and the
    counters equal, x and y within rtol 1e-9 (atol 1e-11) at convergence, and the port's
    own engine the same."""
    a, b = srl_problem
    m, n = a.shape
    na = float(np.linalg.norm(a))
    aj, hj, fj, gj = _srl(srl_problem, "jax")
    at_, ht, ft, gt = _srl(srl_problem, "torch")
    rj = jpf.fused_adaptive_primal_dual(jnp.zeros(n), jnp.zeros(m), f=fj, g=gj, h=hj, A=aj,
                                        rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), tol=1e-9,
                                        maxit=400)
    kw = dict(f=ft, g=gt, h=ht, rule=apt.AdaPGMRule.make(t=1.0, norm_a=na), tol=1e-9,
              maxit=400)
    z = torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64)
    rt = apt.fused_adaptive_primal_dual(*z, A=at_, **kw)
    assert rt.numit == int(rj.numit) < 400
    np.testing.assert_allclose(np_of(rt.x), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np_of(rt.y), np.asarray(rj.y), rtol=1e-9, atol=1e-11)
    _assert_counters_equal(rt, rj)
    re = apt.adaptive_primal_dual(*z, A=apt.DenseOperator(at_), **kw)
    assert re.numit == rt.numit and tuple(re.counters) == tuple(rt.counters)
    np.testing.assert_allclose(np_of(rt.x), np_of(re.x), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np_of(rt.y), np_of(re.y), rtol=1e-9, atol=1e-11)
    assert rt.name == "AdaPDM (fused)" and not bool(rt.diag["rule_nan"])


def test_fused_condat_vu_matches_jax(srl_problem):
    """fused_condat_vu to tol 1e-9 (maxit 300, ||A||_2 given) against JAX's: numit, the
    counters, x and y (rtol 1e-9, atol 1e-11); the port's engine condat_vu the same; with
    norm_A omitted both take the Frobenius norm."""
    a, b = srl_problem
    m, n = a.shape
    na = float(np.linalg.norm(a, 2))
    aj, hj, fj, gj = _srl(srl_problem, "jax")
    at_, ht, ft, gt = _srl(srl_problem, "torch")
    z = torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64)
    for norm_a in (na, None):
        rj = jpf.fused_condat_vu(jnp.zeros(n), jnp.zeros(m), f=fj, g=gj, h=hj, A=aj, Lf=0.0,
                                 norm_A=norm_a, tol=1e-9, maxit=300)
        rt = apt.fused_condat_vu(*z, f=ft, g=gt, h=ht, A=at_, Lf=0.0, norm_A=norm_a, tol=1e-9,
                                 maxit=300)
        assert rt.numit == int(rj.numit)
        np.testing.assert_allclose(np_of(rt.x), np.asarray(rj.x), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np_of(rt.y), np.asarray(rj.y), rtol=1e-9, atol=1e-11)
        _assert_counters_equal(rt, rj)
    re = apt.condat_vu(*z, f=ft, g=gt, h=ht, A=apt.DenseOperator(at_), Lf=0.0, norm_A=na,
                       tol=1e-9, maxit=300)
    rt = apt.fused_condat_vu(*z, f=ft, g=gt, h=ht, A=at_, at=at_.t().contiguous(), Lf=0.0,
                             norm_A=na, tol=1e-9, maxit=300)
    assert re.numit == rt.numit and tuple(re.counters) == tuple(rt.counters)
    np.testing.assert_allclose(np_of(rt.x), np_of(re.x), rtol=1e-9, atol=1e-11)
    assert rt.name == "Condat-Vu (fused)"


# the adaptive rule amplifies summation-order differences (JAX's interpret kernel sums by
# elementwise products, the port by torch.mv): over 50 iterations of AdaPGM on srl_problem
# the record rows parted from JAX's by at most 3e-12 (relative), so rtol 1e-9 holds there
RECORD_HORIZON = 50


@pytest.mark.parametrize("solver", ["adapdm", "condat_vu"])
def test_fused_records_match_jax(srl_problem, solver):
    """history=True over RECORD_HORIZON iterations at tol 0: the counter columns exactly
    and gamma, sigma, norm_res and the objective within rtol 1e-9 of JAX's (norm_res also
    atol 1e-12, once at the rounding floor)."""
    a, b = srl_problem
    m, n = a.shape
    na = float(np.linalg.norm(a))
    aj, hj, fj, gj = _srl(srl_problem, "jax")
    at_, ht, ft, gt = _srl(srl_problem, "torch")
    common = dict(tol=0.0, maxit=RECORD_HORIZON, history=True)
    if solver == "adapdm":
        rj = jpf.fused_adaptive_primal_dual(jnp.zeros(n), jnp.zeros(m), f=fj, g=gj, h=hj, A=aj,
                                            rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), **common)
        rt = apt.fused_adaptive_primal_dual(
            torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64), f=ft, g=gt, h=ht, A=at_,
            rule=apt.AdaPGMRule.make(t=1.0, norm_a=na), **common)
    else:
        rj = jpf.fused_condat_vu(jnp.zeros(n), jnp.zeros(m), f=fj, g=gj, h=hj, A=aj, Lf=0.0,
                                 norm_A=na, **common)
        rt = apt.fused_condat_vu(torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64), f=ft,
                                 g=gt, h=ht, A=at_, Lf=0.0, norm_A=na, **common)
    tr, jr = rt.records.numpy(), rj.records
    valid = np.asarray(jr.valid)
    assert valid.sum() == len(tr.it) == RECORD_HORIZON
    for k in ("it", "f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
              "At_evals"):
        np.testing.assert_array_equal(getattr(tr, k), np.asarray(getattr(jr, k))[valid], k)
    assert (tr.A_evals[0], tr.At_evals[0], tr.A_evals[-1], tr.At_evals[-1]) == (
        2, 1, RECORD_HORIZON + 1, RECORD_HORIZON)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        # Condat-Vu's residual reaches the f64 rounding floor (~2e-14) inside the horizon
        np.testing.assert_allclose(getattr(tr, k), np.asarray(getattr(jr, k))[valid],
                                   rtol=1e-9, atol=1e-12 if k == "norm_res" else 0,
                                   err_msg=k)


# AdaPGM amplifies the summation order of A'y (K5's plain torch.mv on A', the engine's on
# A.t(), JAX's interpret kernel by elementwise products): with this smooth f the gamma rows
# part from each other by more than 1e-9 first at iteration 95, so they are held over 40
SMOOTH_HORIZON = 40


def _smooth_case():
    """A smooth f (LeastSquares, 200 x 128, plain), g = ElasticNet(0.5, 0.3) and h =
    Translate(L2Norm(1), -c) on an aligned 24 x 128 coupling."""
    rng = np.random.default_rng(7)
    a, c = rng.standard_normal((24, 128)), rng.standard_normal(24)
    af, bf = rng.standard_normal((200, 128)), rng.standard_normal(200)
    jax_side = dict(f=JLS(a=jnp.asarray(af), b=jnp.asarray(bf)),
                    g=ap.ElasticNet(lam1=0.5, lam2=0.3),
                    h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(c)))
    port = dict(f=apt.LeastSquares(t64(af), t64(bf)), g=apt.ElasticNet(0.5, 0.3),
                h=apt.Translate(apt.L2Norm(1.0), -t64(c)))
    return a, float(np.linalg.norm(af, 2) ** 2), jax_side, port


def test_fused_condat_vu_with_smooth_f_matches_the_engine_and_jax():
    """fused_condat_vu with the smooth f of ``_smooth_case`` (Lf = ||A_f||_2^2) to tol 1e-9:
    numit and the counters equal the port's engine condat_vu and JAX's fused solve, x and y
    within rtol 1e-9 (atol 1e-11) of both (fixed steps: nothing amplifies the summation
    order)."""
    a, lf, jkw, tkw = _smooth_case()
    kw = dict(Lf=lf, tol=1e-9, maxit=3000)
    rj = jpf.fused_condat_vu(jnp.zeros(128), jnp.zeros(24), A=jnp.asarray(a), **jkw, **kw)
    z = torch.zeros(128, dtype=F64), torch.zeros(24, dtype=F64)
    rt = apt.fused_condat_vu(*z, A=t64(a), **tkw, **kw)
    re = apt.condat_vu(*z, A=apt.DenseOperator(t64(a)), **tkw, **kw)
    assert rt.numit == re.numit == int(rj.numit) < 3000
    assert tuple(rt.counters) == tuple(re.counters)
    _assert_counters_equal(rt, rj)
    for got, others in ((rt.x, (re.x, rj.x)), (rt.y, (re.y, rj.y))):
        for other in others:
            np.testing.assert_allclose(np_of(got), np_of(other), rtol=1e-9, atol=1e-11)


def test_fused_adapdm_with_smooth_f_matches_the_engine_and_jax():
    """fused_adaptive_primal_dual with the smooth f of ``_smooth_case`` and AdaPGMRule, tol
    0: the counter columns exactly and gamma, sigma, norm_res and the objective within rtol
    1e-9 of the port's engine and of JAX's fused solve over SMOOTH_HORIZON iterations."""
    a, _, jkw, tkw = _smooth_case()
    na = float(np.linalg.norm(a))
    kw = dict(tol=0.0, maxit=SMOOTH_HORIZON, history=True)
    rj = jpf.fused_adaptive_primal_dual(jnp.zeros(128), jnp.zeros(24), A=jnp.asarray(a),
                                        rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), **jkw, **kw)
    z = torch.zeros(128, dtype=F64), torch.zeros(24, dtype=F64)
    rule = apt.AdaPGMRule.make(t=1.0, norm_a=na)
    rt = apt.fused_adaptive_primal_dual(*z, A=t64(a), rule=rule, **tkw, **kw)
    re = apt.adaptive_primal_dual(*z, A=apt.DenseOperator(t64(a)), rule=rule, **tkw, **kw)
    tr, er, jr = rt.records.numpy(), re.records.numpy(), rj.records
    for k in ("it", "f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
              "At_evals"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(er, k), k)
        np.testing.assert_array_equal(getattr(tr, k), np.asarray(getattr(jr, k)), k)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        for other in (getattr(er, k), np.asarray(getattr(jr, k))):
            np.testing.assert_allclose(getattr(tr, k), other, rtol=1e-9, atol=0, err_msg=k)


PAD_HORIZON = 150


@pytest.mark.parametrize("smooth", ["zero", "least_squares"])
def test_autopad_matches_jax_and_the_unpadded_engine(smooth):
    """A LIBSVM-shaped 61 x 14 coupling (A' 14 x 61 pads to 16 x 128): PadDomain and
    PadTail make the padded solve follow the unpadded one: numit and counters equal JAX's
    auto-pad and the port's unpadded engine, x (14,) and y (61,) within rtol 1e-9 of both;
    the rows within rtol 1e-9 (atol 1e-12) of the engine's, all of them with f = 0 (gamma
    bit for bit) and over PAD_HORIZON iterations with a smooth f."""
    rng = np.random.default_rng(8)
    a, c = rng.standard_normal((61, 14)), rng.standard_normal(61)
    na = float(np.linalg.norm(a))
    if smooth == "zero":
        fj, ft = ap.ZeroSmooth(), apt.ZeroSmooth()
    else:
        af, bf = rng.standard_normal((20, 14)), rng.standard_normal(20)
        fj, ft = JLS(a=jnp.asarray(af), b=jnp.asarray(bf)), apt.LeastSquares(t64(af), t64(bf))
    kw = dict(tol=1e-9, maxit=1000)
    rj = jpf.fused_adaptive_primal_dual(
        jnp.zeros(14), jnp.zeros(61), f=fj, g=ap.L1Norm(lam=1.0),
        h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(c)), A=jnp.asarray(a),
        rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), **kw)
    tkw = dict(f=ft, g=apt.L1Norm(1.0), h=apt.Translate(apt.L2Norm(1.0), -t64(c)),
               rule=apt.AdaPGMRule.make(t=1.0, norm_a=na), **kw)
    z = torch.zeros(14, dtype=F64), torch.zeros(61, dtype=F64)
    rt = apt.fused_adaptive_primal_dual(*z, A=t64(a), history=True, **tkw)
    re = apt.adaptive_primal_dual(*z, A=apt.DenseOperator(t64(a)), history=True, **tkw)
    assert rt.x.shape == (14,) and rt.y.shape == (61,)
    assert rt.numit == re.numit == int(rj.numit) < 1000
    assert tuple(rt.counters) == tuple(re.counters)
    _assert_counters_equal(rt, rj)
    for got, others in ((rt.x, (re.x, rj.x)), (rt.y, (re.y, rj.y))):
        for other in others:
            np.testing.assert_allclose(np_of(got), np_of(other), rtol=1e-9, atol=1e-11)
    tr, er = rt.records.numpy(), re.records.numpy()
    # f = 0: the step sizes are the unpadded solve's bit for bit (the residuals' sums
    # over padded vectors move their last bits); with a smooth f the rule amplifies the
    # padded sums' order (gamma parts by 1e-9 first at iteration 180)
    horizon = len(tr.it) if smooth == "zero" else PAD_HORIZON
    for k in ("norm_res", "objective", "gamma"):
        np.testing.assert_allclose(getattr(tr, k)[:horizon], getattr(er, k)[:horizon],
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    if smooth == "zero":
        np.testing.assert_array_equal(tr.gamma, er.gamma)
    np.testing.assert_array_equal(tr.A_evals, er.A_evals)


def test_fused_refusals():
    """As JAX: pad=False on a misaligned A ("tile-aligned"), an IndBox excluding 0 under
    auto-pad ("prox_g"), at of the wrong shape, a g outside the menu; the options not
    ported yet raise NotImplementedError naming ROADMAP.md."""
    rng = np.random.default_rng(9)
    a = t64(rng.standard_normal((10, 10)))
    z = torch.zeros(10, dtype=F64)
    common = dict(f=apt.ZeroSmooth(), h=apt.IndZero(), rule=apt.AdaPGMRule(gamma=0.1),
                  maxit=5)
    with pytest.raises(ValueError, match="tile-aligned"):
        apt.fused_adaptive_primal_dual(z, z, g=apt.L1Norm(1.0), A=a, pad=False, **common)
    with pytest.raises(ValueError, match="prox_g"):
        apt.fused_adaptive_primal_dual(z, z, g=apt.IndBox(1.0, 2.0), A=a, **common)
    with pytest.raises(ValueError, match="not the transpose"):
        apt.fused_adaptive_primal_dual(z, z, g=apt.L1Norm(1.0), A=a, at=a[:, :8], **common)
    with pytest.raises(ValueError, match="not in the fused prox menu"):
        apt.fused_adaptive_primal_dual(z, z, g=apt.L2Norm(1.0), A=a, **common)
    for opt, val in (("resume_state", object()), ("it_cap", 3), ("mesh", object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            apt.fused_adaptive_primal_dual(z, z, g=apt.L1Norm(1.0), A=a, **{opt: val},
                                           **common)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            apt.fused_condat_vu(z, z, f=apt.ZeroSmooth(), g=apt.L1Norm(1.0), h=apt.IndZero(),
                                A=a, Lf=0.0, **{opt: val})
    # a box containing 0 auto-pads; the menu maps each prox
    apt.fused_adaptive_primal_dual(z, z, g=apt.IndBox(-1.0, 2.0), A=a, **common)
    assert tpf.prox_menu_entry(apt.ElasticNet(1.0, 2.0)) == ("elastic", 1.0, 2.0)
    assert tpf.prox_menu_entry(apt.IndBox(0.0, 1.0)) == ("box", 0.0, 1.0)
    assert tpf.prox_menu_entry(apt.Zero()) == ("zero", 0.0, 0.0)
    assert tpf.prox_menu_entry(apt.L1Norm(2.0)) == ("l1", 2.0, 0.0)
    assert tpf.prox_menu_entry(apt.L2Norm(1.0)) is None


def test_fused_rule_nan_latch_matches_jax(srl_problem):
    """A rule built directly (not through .make) with gamma past the coupling bound takes
    the square root of a negative number at its first update: both fused solvers latch
    the NaN step in diag["rule_nan"] and run to maxit."""
    a, b = srl_problem
    m, n = a.shape
    kw = dict(gamma=1.0, t=1.0, norm_a=float(np.linalg.norm(a)), delta=100.0)
    aj, hj, fj, gj = _srl(srl_problem, "jax")
    at_, ht, ft, gt = _srl(srl_problem, "torch")
    rj = jpf.fused_adaptive_primal_dual(jnp.zeros(n), jnp.zeros(m), f=fj, g=gj, h=hj, A=aj,
                                        rule=ap.AdaPGMRule(**kw), tol=1e-6, maxit=5)
    rt = apt.fused_adaptive_primal_dual(torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64),
                                        f=ft, g=gt, h=ht, A=at_, rule=apt.AdaPGMRule(**kw),
                                        tol=1e-6, maxit=5)
    assert bool(rj.diag["rule_nan"]) and bool(rt.diag["rule_nan"])
    assert rt.numit == int(rj.numit) == 5


# -- the f = 0 drivers' --fused ------------------------------------------------------------


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


DRIVER_NAMES = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in tsl.T_VALUES]
                + [f"AdaPDM+ (t={t})" for t in tsl.T_VALUES])


@pytest.mark.parametrize("which", ["sqrt_lasso", "lad"])
def test_driver_fused_matches_jax(tmp_path, capsys, no_download, which):
    """--fused --maxit 60 on housing_scale's and abalone's stand-ins (A' auto-pads to 16 x
    512 and 16 x 4224) against the JAX driver's --cpu --f64 --fused: the 31 rows in JAX's
    order, the counters row by row exactly (the Condat-Vu rows from 2 / 1 to 61 / 60),
    norm_res within rtol 1e-9 on the fused Condat-Vu rows and 1e-7 on the engine's
    t-sweep rows (abalone's Malitsky-Pock t = 0.2 parts from JAX's by 1.5e-8 at iteration
    60: its linesearch amplifies the summation order), and the meta rows' fast_path
    "fused" and fast_methods ["Condat-Vu"]."""
    jmod, tmod = {"sqrt_lasso": (jsl, tsl), "lad": (jlad, tlad)}[which]
    args = ["--datasets", "housing_scale,abalone", "--maxit", "60", "--no-plot", "--fused"]
    jmod.main(["--cpu", "--f64", "--outdir", str(tmp_path / "jax"), *args])
    tmod.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    capsys.readouterr()
    for name in ("housing_scale", "abalone"):
        jrows, trows = (tlog.read_jsonl(tmp_path / side / f"{name}.jsonl")
                        for side in ("jax", "torch"))
        by = []
        for rows in (jrows, trows):
            d = {}
            for r in rows:
                if "norm_res" in r:
                    d.setdefault(r["method"], []).append(r)
            by.append(d)
        jby, tby = by
        assert list(tby) == list(jby) == DRIVER_NAMES
        for method in DRIVER_NAMES:
            rel = 1e-9 if method == "Condat-Vu" else 1e-7
            assert len(tby[method]) == len(jby[method]), method
            for rt, rj in zip(tby[method], jby[method], strict=True):
                assert list(rt) == tsl.KEYS
                assert (rt["method"], rt["A_evals"], rt["At_evals"]) == (
                    rj["method"], rj["A_evals"], rj["At_evals"]), method
                assert rt["norm_res"] == pytest.approx(rj["norm_res"], rel=rel), method
        cv = tby["Condat-Vu"]
        assert len(cv) == 60 and (cv[0]["A_evals"], cv[0]["At_evals"], cv[-1]["A_evals"], cv[-1]["At_evals"]) == (
            2, 1, 61, 60)
        tmeta = [r for r in trows if "norm_res" not in r]
        jmeta = [r for r in jrows if "norm_res" not in r]
        assert [list(r) for r in tmeta] == [list(r) for r in jmeta]
        assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == "fused"
        assert tmeta[0]["fast_methods"] == jmeta[0]["fast_methods"] == ["Condat-Vu"]
        assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"])
        assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}
