"""The dual-SVM primal-dual path of the PyTorch port against the JAX package,
on the same numpy inputs (f64 on the CPU): the conjugates and the dense
operator, ``Quadratic`` and ``FactoredQuadratic``, the engine's dual branch
and ``condat_vu``, the plain versions of K6a, K6b and K6d, and the
``dual_svm`` driver's JSONL (all 25 rows; the Malitsky-Pock pieces on their own
are in tests/test_torch_mp.py).

The JAX side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does; the port's wrappers take their plain versions on CPU tensors. The CUDA
kernel is tested on the card (tests/test_torch_cuda.py) and by chip_smoke.py.

About the horizons. AdaPDM's step-size rule amplifies summation-order
differences as AdaPGM's does (ROADMAP, "Trajectory parity has a horizon"); the
fixed steps of Condat-Vu contract them. Measured on the CPU in f64, tol 0,
the first step size or residual past rtol 1e-9: the engine against JAX's
engine on the ``dsvm`` problem (40 points, dense Q or factored B) never in
300 iterations for t = 1 and 0.5 and for Condat-Vu, but at iteration 86 for
t = 0.1 (the residual at 101); the plain kernels against JAX's interpret-mode
kernels (128 points, dense and factored) never in 300 (worst 1e-10 on the
step sizes); the driver's rows on heart_scale's stand-in never in 80. The
rows are held to rtol 1e-9 over 200 iterations, t = 0.1 over 55. Solved to
tol, both sides stop at the same iteration on these problems; the test allows
the engine tests' 10%.
"""

import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of
from test_reference_mirror import np_adaptive_pd

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import dual_svm as jdriver
from adaprox_tpu.models.objectives import FactoredQuadratic as JFQ
from adaprox_tpu.models.objectives import Quadratic as JQ
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import dual_svm as tdriver
from adaprox_tpu_torch.ops import resident_pd as tpd

F64 = torch.float64
COUNTERS = ("f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals", "At_evals")
HORIZON = 200
ENGINE_HORIZON = {1.0: HORIZON, 0.1: 55, None: HORIZON}  # by t; None: Condat-Vu


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# -- the conjugates and the dense operator ---------------------------------------------------


@pytest.mark.parametrize("name", ["zero", "ind_zero", "l1", "box", "moreau_box"])
def test_prox_and_conjugates_match_jax(name):
    v = np.random.default_rng(0).standard_normal(17) * 2
    v[3] = 0.0
    make = {"zero": lambda m: m.Zero(), "ind_zero": lambda m: m.IndZero(),
            "l1": lambda m: m.L1Norm(0.7), "box": lambda m: m.IndBox(-0.5, 1.25),
            "moreau_box": lambda m: m.MoreauConjugate(m.IndBox(-0.5, 1.25))}[name]
    fj, ft = make(ap), make(apt)
    for gamma in (0.3, 2.0):
        yj, _ = fj.prox(jnp.asarray(v), gamma)
        yt, _ = ft.prox(t64(v), gamma)
        np.testing.assert_allclose(np_of(yt), np_of(yj), rtol=1e-15, atol=1e-15)
    # the conjugate: the same class and parameters on both sides, the same prox
    if name != "moreau_box":
        cj, ct = ap.conjugate(fj), apt.conjugate(ft)
        assert type(ct).__name__ == type(cj).__name__
        for gamma in (0.3, 2.0):
            np.testing.assert_allclose(np_of(ct.prox(t64(v), gamma)[0]),
                                       np_of(cj.prox(jnp.asarray(v), gamma)[0]), rtol=1e-15)
    if name in ("ind_zero", "box"):
        for x in (np.zeros(4), np.array([0.0, 1.0, -0.5, 1.25]), np.array([0.0, 2.0, 0, 0])):
            assert float(ft(t64(x))) == float(fj(jnp.asarray(x)))


def test_box_clamp_propagates_nan_and_generic_conjugate_is_moreau():
    y, _ = apt.IndBox(0.0, 1.0).prox(torch.tensor([float("nan"), -1.0, 3.0], dtype=F64), 1.0)
    assert torch.isnan(y[0]) and y[1:].tolist() == [0.0, 1.0]
    c = apt.conjugate(apt.IndBox(0.0, 1.0))
    assert isinstance(c, apt.MoreauConjugate)
    with pytest.raises(NotImplementedError):
        c(torch.zeros(2))


@pytest.mark.parametrize("storage", [F64, torch.bfloat16])
def test_dense_operator_matches_jax(storage):
    a = np.random.default_rng(1).standard_normal((3, 11))
    x, y = np.random.default_rng(2).standard_normal(11), np.random.default_rng(3).standard_normal(3)
    jdt = jnp.float64 if storage == F64 else jnp.bfloat16
    oj = ap.DenseOperator(a=jnp.asarray(a, jdt))
    ot = apt.DenseOperator(t64(a).to(storage))
    vdt = jnp.float64 if storage == F64 else jnp.float32
    xt = t64(x).to(F64 if storage == F64 else torch.float32)
    yt = t64(y).to(xt.dtype)
    assert ot.shape == (3, 11)
    rtol = 1e-14 if storage == F64 else 1e-6
    np.testing.assert_allclose(np_of(ot.matvec(xt)), np_of(oj.matvec(jnp.asarray(x, vdt))),
                               rtol=rtol)
    np.testing.assert_allclose(np_of(ot.rmatvec(yt)), np_of(oj.rmatvec(jnp.asarray(y, vdt))),
                               rtol=rtol)
    assert ot.matvec(xt).dtype == xt.dtype
    np.testing.assert_allclose(float(ot.norm()), float(oj.norm()), rtol=rtol)
    np.testing.assert_allclose(float(apt.frobenius_norm(ot.a)), float(oj.norm()), rtol=rtol)


# -- Quadratic and FactoredQuadratic ----------------------------------------------------------


@pytest.mark.parametrize("factored", [False, True])
def test_quadratics_match_jax(factored):
    rng = np.random.default_rng(4)
    b = rng.standard_normal((30, 7))
    qv = rng.standard_normal(30)
    x, x_prev = rng.standard_normal(30), rng.standard_normal(30)
    if factored:
        fj = JFQ(b_mat=jnp.asarray(b), q_vec=jnp.asarray(qv))
        ft = apt.factored_from_numpy(b, qv, device="cpu", dtype=F64)
        assert dict(ft.named_buffers()).keys() == {"b_mat", "q_vec"}
        np.testing.assert_allclose(float(ft.norm_q()), float(fj.norm_q()), rtol=1e-14)
        np.testing.assert_allclose(float(ft.norm_q()), np.linalg.norm(b @ b.T), rtol=1e-13)
    else:
        fj = JQ(q_mat=jnp.asarray(b @ b.T), q_vec=jnp.asarray(qv))
        ft = apt.quadratic_from_numpy(b @ b.T, qv, device="cpu", dtype=F64)
    vj, auxj = fj.value_and_aux(jnp.asarray(x))
    vt, auxt = ft.value_and_aux(t64(x))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-13)
    np.testing.assert_allclose(np_of(auxt), np_of(auxj), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np_of(ft.grad_from_aux(t64(x), auxt)),
                               np_of(fj.grad_from_aux(jnp.asarray(x), auxj)), rtol=1e-13,
                               atol=1e-13)
    assert float(ft(t64(x))) == float(vt)
    _, auxj0 = fj.value_and_aux(jnp.asarray(x_prev))
    _, auxt0 = ft.value_and_aux(t64(x_prev))
    dx = x - x_prev
    bt = ft.bregman_from_aux(t64(dx), auxt, auxt0)
    np.testing.assert_allclose(float(bt), float(fj.bregman_from_aux(jnp.asarray(dx), auxj,
                                                                     auxj0)), rtol=1e-12)
    np.testing.assert_allclose(float(bt), 0.5 * np.sum((b.T @ dx) ** 2), rtol=1e-12)


def test_factored_bf16_storage_norm_q_accumulates_in_f32():
    b = np.random.default_rng(5).standard_normal((300, 9)).astype(np.float32)
    ft = apt.factored_from_numpy(b, -np.ones(300), device="cpu", dtype=torch.bfloat16)
    fj = JFQ(b_mat=jnp.asarray(b, jnp.bfloat16), q_vec=-jnp.ones(300, jnp.float32))
    assert ft.b_mat.dtype == torch.bfloat16 and ft.q_vec.dtype == torch.float32
    nt = ft.norm_q()
    assert nt.dtype == torch.float32
    np.testing.assert_allclose(float(nt), float(fj.norm_q()), rtol=1e-6)
    v, qx = ft.value_and_aux(torch.ones(300))
    assert v.dtype == qx.dtype == torch.float32


# -- the engine's dual branch and Condat-Vu ---------------------------------------------------


def dsvm_case(n_pts=40, n_feat=6, seed=7):
    """tests/test_primal_dual.py's ``dsvm`` problem as numpy arrays: (dyx, labels,
    big_c, norm_a, lf) with lf the spectral norm of the Gram."""
    rng = np.random.default_rng(seed)
    x_data = rng.standard_normal((n_pts, n_feat))
    labels = np.sign(rng.standard_normal(n_pts))
    labels[labels == 0] = 1.0
    dyx = labels[:, None] * x_data
    return dyx, labels, 0.5, float(np.linalg.norm(labels)), float(np.linalg.norm(dyx @ dyx.T, 2))


def _pd_solve(side, method, t=1.0, tol=0.0, maxit=HORIZON, history=True, factored=False):
    dyx, labels, big_c, norm_a, lf = dsvm_case()
    n = labels.shape[0]
    if side == "jax":
        f = (JFQ(b_mat=jnp.asarray(dyx), q_vec=-jnp.ones(n)) if factored else
             JQ(q_mat=jnp.asarray(dyx @ dyx.T), q_vec=-jnp.ones(n)))
        mod, z, zy = ap, jnp.zeros(n), jnp.zeros(1)
        a_op = ap.DenseOperator(a=jnp.asarray(labels[None, :]))
        g, h = ap.IndBox(lo=0.0, hi=big_c), ap.IndZero()
    else:
        if factored:
            f, g, h, a_op = apt.dsvm_from_numpy(dyx / labels[:, None], labels, big_c,
                                                device="cpu", dtype=F64)
        else:
            f = apt.quadratic_from_numpy(dyx @ dyx.T, -np.ones(n), device="cpu", dtype=F64)
            g, h, a_op = apt.IndBox(0.0, big_c), apt.IndZero(), apt.DenseOperator(
                t64(labels[None, :]))
        mod, z, zy = apt, torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64)
    kw = dict(f=f, g=g, h=h, A=a_op, tol=tol, maxit=maxit, history=history)
    if method == "cv":
        return mod.condat_vu(z, zy, Lf=lf, **kw)
    return mod.adaptive_primal_dual(z, zy, rule=mod.AdaPGMRule.make(t=t, norm_a=norm_a), **kw)


def _rows_match(rt, rj, horizon, rtol=1e-9):
    valid = np_of(rj.records.valid).astype(bool)
    assert len(rt.records.it) == valid.sum()
    for k in ("gamma", "sigma", "norm_res"):
        np.testing.assert_allclose(np_of(getattr(rt.records, k))[:horizon],
                                   np_of(getattr(rj.records, k))[valid][:horizon], rtol=rtol)
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k))[valid])


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("method,t", [("adapdm", 1.0), ("adapdm", 0.1), ("cv", None)])
def test_pd_engine_rows_match_jax(method, t, factored):
    maxit = ENGINE_HORIZON[t]
    rj = _pd_solve("jax", method, t=t, maxit=maxit, factored=factored)
    rt = _pd_solve("torch", method, t=t, maxit=maxit, factored=factored)
    assert rt.numit == int(rj.numit) == maxit
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    _rows_match(rt, rj, maxit)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np_of(rt.y), np_of(rj.y), rtol=1e-9, atol=1e-12)
    # the record objective is f + g + h(Ax): h = IndZero is +inf off the constraint
    obj_t, obj_j = np_of(rt.records.objective), np_of(rj.records.objective)
    np.testing.assert_array_equal(np.isinf(obj_t), np.isinf(obj_j[np_of(rj.records.valid)]))


@pytest.mark.parametrize("t", [1.0, 0.2, 5.0])
def test_pd_engine_matches_numpy_mirror(t):
    """The engine's AdaPDM against the reference loop transcribed in numpy
    (tests/test_reference_mirror.py), step sizes and residuals to rtol 1e-7
    over 80 iterations, as the JAX engine is held."""
    dyx, labels, big_c, norm_a, _ = dsvm_case(n_pts=24, n_feat=5, seed=3)
    n = labels.shape[0]
    q = dyx @ dyx.T
    gammas, res = np_adaptive_pd(q, -np.ones(n), labels, big_c, t, norm_a, 80)
    rt = apt.adaptive_primal_dual(
        torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64),
        f=apt.quadratic_from_numpy(q, -np.ones(n), device="cpu", dtype=F64),
        g=apt.IndBox(0.0, big_c), h=apt.IndZero(), A=apt.DenseOperator(t64(labels[None, :])),
        rule=apt.AdaPGMRule.make(t=t, norm_a=norm_a), tol=0.0, maxit=80, history=True)
    np.testing.assert_allclose(np_of(rt.records.gamma), gammas, rtol=1e-7)
    np.testing.assert_allclose(np_of(rt.records.norm_res), res, rtol=1e-7)


@pytest.mark.parametrize("method", ["adapdm", "cv"])
def test_pd_engine_converges_to_jax_solution(method):
    tol = 1e-6
    rj = _pd_solve("jax", method, tol=tol, maxit=50_000, history=False)
    rt = _pd_solve("torch", method, tol=tol, maxit=50_000, history=False)
    dyx, labels, big_c, _, _ = dsvm_case()
    for r in (rj, rt):
        numit = int(r.numit)
        assert numit < 50_000 and float(r.norm_res) <= tol
        # at convergence the counters are the at-check snapshot (test_primal_dual.py:111)
        c = dict(zip(COUNTERS, [int(v) for v in r.counters]))
        assert c == dict(f_evals=numit + 1, grad_f_evals=numit + 1, prox_g_evals=numit,
                         prox_h_evals=numit, A_evals=numit + 1, At_evals=numit)
    assert abs(rt.numit - int(rj.numit)) <= 0.1 * int(rj.numit)
    xt, xj = np_of(rt.x), np_of(rj.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6 * np.abs(xj).max())
    assert (xt >= 0).all() and (xt <= big_c).all() and abs(labels @ xt) < 50 * tol


def test_pd_engine_argument_errors():
    dyx, labels, big_c, norm_a, _ = dsvm_case()
    n = labels.shape[0]
    f = apt.quadratic_from_numpy(dyx @ dyx.T, -np.ones(n), device="cpu", dtype=F64)
    kw = dict(f=f, g=apt.IndBox(0.0, big_c), rule=apt.AdaPGMRule(gamma=1e-2))
    x0 = torch.zeros(n, dtype=F64)
    with pytest.raises(ValueError, match="h was given without A"):
        apt.adaptive_primal_dual(x0, h=apt.L1Norm(1.0), **kw)
    with pytest.raises(ValueError, match="y0 was given without A"):
        apt.adaptive_primal_dual(x0, torch.zeros(1, dtype=F64), **kw)
    a_op = apt.DenseOperator(t64(labels[None, :]))
    with pytest.raises(ValueError, match="y0 is required"):
        apt.adaptive_primal_dual(x0, A=a_op, **kw)
    for opt, val in (("resume_state", object()), ("scalar_dtype", F64), ("it_cap", 5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            apt.adaptive_primal_dual(x0, torch.zeros(1, dtype=F64), A=a_op, **{opt: val}, **kw)
    with pytest.raises(ValueError, match="both gamma and sigma"):
        apt.condat_vu(x0, torch.zeros(1, dtype=F64), f=f, g=apt.IndBox(0.0, big_c),
                      h=apt.IndZero(), A=a_op, Lf=1.0, gamma=0.1)
    # h omitted with A: h(Ax) = 0, a Zero h, whose conjugate prox sends y to 0
    r = apt.adaptive_primal_dual(x0, torch.zeros(1, dtype=F64), A=a_op, maxit=5, tol=0.0,
                                 **kw)
    assert r.numit == 5 and float(r.y.abs().max()) == 0.0


def test_condat_vu_steps_match_jax():
    from adaprox_tpu.solvers.primal_dual import condat_vu_steps as jsteps

    for lf, na in ((3.0, 20.0), (30.0, 2.0), (0.0, 1.5)):
        gj, sj = jsteps(jnp.asarray(lf), jnp.asarray(na))
        gt, st = apt.condat_vu_steps(t64(lf), t64(na))
        assert float(gt) == pytest.approx(float(gj), rel=1e-15)
        assert float(st) == pytest.approx(float(sj), rel=1e-15)
        assert (float(gt), float(st)) == pytest.approx(tdriver.cv_steps(lf, na), rel=1e-15)


# -- the plain versions of K6a, K6b and K6d ---------------------------------------------------


def pd_kernel_case(n=100, n_pad=128, d=9, d_pad=16, seed=5):
    """A dual SVM of n points zero-padded to n_pad: (q_pad, b_pad, lab_pad, n, norm_a, lf)
    with the Gram (n_pad, n_pad) and B = D_y X padded to (n_pad, d_pad)."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((n, d)) / 3
    lb = np.sign(rng.standard_normal(n))
    lb[lb == 0] = 1
    dyx = lb[:, None] * xb
    q = np.zeros((n_pad, n_pad))
    q[:n, :n] = dyx @ dyx.T
    b = np.zeros((n_pad, d_pad))
    b[:n, :d] = dyx
    lab = np.zeros(n_pad)
    lab[:n] = lb
    return q, b, lab, n, float(np.linalg.norm(lb)), float(np.linalg.norm(dyx.T @ dyx))


TS = [0.05, 0.5, 2.0]


def _close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np_of(got).astype(np.float64), np_of(want).astype(np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_true", [100, 128])
@pytest.mark.parametrize("factored", [False, True])
def test_k6b_plain_matches_jax(factored, n_true):
    q, b, lab, n, na, _ = pd_kernel_case()
    n_true = n if n_true == 100 else None
    mat = b if factored else q
    kw = dict(n_true=n_true, record=True, factored=factored)
    want = jr.resident_adapdm_dsvm_sweep(jnp.asarray(mat), jnp.asarray(lab), 0.1,
                                         jnp.asarray(TS), na, 0.0, HORIZON, interpret=True, **kw)
    got = tpd.resident_adapdm_dsvm_sweep(t64(mat), t64(lab), 0.1, TS, na, 0.0, HORIZON, **kw)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool
    assert got[1].tolist() == np_of(want[1]).tolist() == [HORIZON] * 3
    assert got[4].shape == got[5].shape == (3, HORIZON)
    for u, w in zip(got, want):
        _close(u, w)
    if n_true is not None:
        assert float(got[0][:, n:].abs().max()) == 0.0  # the padded coordinates stay 0


def test_k6a_plain_matches_jax_and_its_sweep_rows():
    q, _, lab, n, na, _ = pd_kernel_case()
    sweep = tpd.resident_adapdm_dsvm_sweep(t64(q), t64(lab), 0.1, TS, na, 1e-6, 3000, n_true=n)
    for j, t in enumerate(TS):
        want = jr.resident_adapdm_dsvm(jnp.asarray(q), jnp.asarray(lab), 0.1, t, na, 1e-6, 3000,
                                       n_true=n, interpret=True)
        got = tpd.resident_adapdm_dsvm(t64(q), t64(lab), 0.1, t, na, 1e-6, 3000, n_true=n)
        # solved to tol: t = 0.5 and 2 stop at the same iteration on both sides,
        # t = 0.05 (the slowest) 3% apart (2563 and 2650), its x 3.4e-8 apart
        assert bool(got[3]) and bool(want[3]) and float(got[2]) <= 1e-6
        assert abs(int(got[1]) - int(want[1])) <= 0.1 * int(want[1])
        _close(got[0], want[0], rtol=0, atol=1e-6)
        # a sweep row is its single solve, bit for bit
        assert torch.equal(sweep[0][j], got[0]) and int(sweep[1][j]) == int(got[1])
        assert float(sweep[2][j]) == float(got[2]) and bool(sweep[3][j]) == bool(got[3])


@pytest.mark.parametrize("factored", [False, True])
def test_k6d_plain_matches_jax_and_its_records(factored):
    q, b, lab, n, na, lf = pd_kernel_case()
    gamma, sigma = tdriver.cv_steps(lf, na)
    mat = b if factored else q
    kw = dict(n_true=n, record=True, factored=factored)
    want = jr.resident_cv_dsvm(jnp.asarray(mat), jnp.asarray(lab), 0.1, gamma, sigma, 0.0,
                               HORIZON, interpret=True, **kw)
    got = tpd.resident_cv_dsvm(t64(mat), t64(lab), 0.1, gamma, sigma, 0.0, HORIZON, **kw)
    for u, w in zip(got[:4], want[:4]):
        _close(u, w)
    for u, w in zip(got[4], want[4]):
        _close(u, w)
    assert float(got[0][n:].abs().max()) == 0.0
    rt = tpd.resident_cv_records(got[1], gamma, sigma, got[4], maxit=HORIZON)
    rj = jr.resident_cv_records(want[1], gamma, sigma, want[4], maxit=HORIZON)
    for k in ("it", "valid") + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), k)
    for k in ("gamma", "sigma", "norm_res", "objective"):
        _close(getattr(rt, k), getattr(rj, k))


def test_k6_records_match_the_engine():
    """resident_pd_records / resident_cv_records of the padded plain kernels equal
    the engine's records on the unpadded problem: counters exactly, rows to 1e-9."""
    q, b, lab, n, na, lf = pd_kernel_case()
    labels = lab[:n]
    f = apt.quadratic_from_numpy(q[:n, :n], -np.ones(n), device="cpu", dtype=F64)
    g, h, a_op = apt.IndBox(0.0, 0.1), apt.IndZero(), apt.DenseOperator(t64(labels[None, :]))
    z, zy = torch.zeros(n, dtype=F64), torch.zeros(1, dtype=F64)
    out = tpd.resident_adapdm_dsvm_sweep(t64(q), t64(lab), 0.1, [0.5], na, 0.0, 80, n_true=n,
                                         record=True)
    recs = tpd.resident_pd_records(out[1][0], out[4][0], out[5][0], maxit=80, t=0.5)
    ref = apt.adaptive_primal_dual(z, zy, f=f, g=g, h=h, A=a_op, tol=0.0, maxit=80,
                                   rule=apt.AdaPGMRule.make(t=0.5, norm_a=na), history=True)
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(recs, k)), np_of(getattr(ref.records, k)))
    for k in ("gamma", "sigma", "norm_res"):
        _close(getattr(recs, k), getattr(ref.records, k))
    _close(out[0][0][:n], ref.x)
    gamma, sigma = tdriver.cv_steps(lf, na)
    out = tpd.resident_cv_dsvm(t64(b), t64(lab), 0.1, gamma, sigma, 0.0, 80, n_true=n,
                               record=True, factored=True)
    recs = tpd.resident_cv_records(out[1], gamma, sigma, out[4], maxit=80)
    ref = apt.condat_vu(z, zy, f=f, g=g, h=h, A=a_op, Lf=lf, tol=0.0, maxit=80, history=True)
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(recs, k)), np_of(getattr(ref.records, k)))
    for k in ("gamma", "sigma", "norm_res"):
        _close(getattr(recs, k), getattr(ref.records, k))
    _close(out[0][:n], ref.x)


@pytest.mark.parametrize("which", ["adapdm", "cv"])
@pytest.mark.parametrize("factored", [False, True])
def test_k6_converged_returns_the_checked_iterate(factored, which):
    """Converged at iteration k, the solve returns the x of the check (JAX's ck_x),
    equal to JAX's, and to a run capped at k - 1 iterations."""
    q, b, lab, n, na, lf = pd_kernel_case()
    mat = b if factored else q
    kw = dict(n_true=n, factored=factored)
    if which == "adapdm":
        def run(mod, m, l, tol, maxit, **k):
            return mod.resident_adapdm_dsvm_sweep(m, l, 0.1, [0.5], na, tol, maxit, **kw, **k)
    else:
        gamma, sigma = tdriver.cv_steps(lf, na)

        def run(mod, m, l, tol, maxit, **k):
            return mod.resident_cv_dsvm(m, l, 0.1, gamma, sigma, tol, maxit, **kw, **k)
    want = run(jr, jnp.asarray(mat), jnp.asarray(lab), 1e-3, 20_000, interpret=True)
    got = run(tpd, t64(mat), t64(lab), 1e-3, 20_000)
    k = int(np_of(got[1]).reshape(-1)[0])
    assert bool(np_of(got[3]).reshape(-1)[0]) and k == int(np_of(want[1]).reshape(-1)[0]) > 1
    _close(got[0], want[0], rtol=1e-8, atol=1e-10)
    capped = run(tpd, t64(mat), t64(lab), -1.0, k - 1)
    assert torch.equal(capped[0], got[0])


def test_k6_bf16_storage_matches_jax():
    """bf16 Q (and B) storage: the iterates follow the f32 labels, and the plain
    version matches JAX's interpret-mode kernel on the same bf16 values."""
    q, b, lab, n, na, lf = pd_kernel_case(seed=8)
    ts = [1.0]
    for mat, factored in ((q, False), (b, True)):
        qj = jnp.asarray(mat, jnp.float32).astype(jnp.bfloat16)
        qt = torch.as_tensor(mat, dtype=torch.float32).to(torch.bfloat16)
        lj, lt = jnp.asarray(lab, jnp.float32), torch.as_tensor(lab, dtype=torch.float32)
        kw = dict(n_true=n, factored=factored, record=True)
        want = jr.resident_adapdm_dsvm_sweep(qj, lj, 0.1, jnp.asarray(ts, jnp.float32), na,
                                             0.0, 30, interpret=True, **kw)
        got = tpd.resident_adapdm_dsvm_sweep(qt, lt, 0.1, ts, na, 0.0, 30, **kw)
        assert got[0].dtype == torch.float32 and got[4].dtype == torch.float32
        for u, w in zip(got, want):
            _close(u, w, rtol=2e-4, atol=1e-6)
        gamma, sigma = tdriver.cv_steps(lf, na)
        want = jr.resident_cv_dsvm(qj, lj, 0.1, gamma, sigma, 0.0, 30, interpret=True, **kw)
        got = tpd.resident_cv_dsvm(qt, lt, 0.1, gamma, sigma, 0.0, 30, **kw)
        for u, w in zip(got[:4] + tuple(got[4]), want[:4] + tuple(want[4])):
            _close(u, w, rtol=2e-4, atol=1e-6)


def test_k6_entries_validate_before_running():
    q = torch.zeros((128, 128), dtype=F64)
    lab = torch.zeros(128, dtype=F64)
    for call in (lambda: tpd.resident_adapdm_dsvm(q, lab, 1.0, 0.0, 5.0, 1e-5, 5),
                 lambda: tpd.resident_adapdm_dsvm(q, lab, 1.0, 1.0, 0.0, 1e-5, 5),
                 lambda: tpd.resident_adapdm_dsvm_sweep(q, lab, 1.0, [0.1], -1.0, 1e-5, 5)):
        with pytest.raises(ValueError, match="must be positive"):
            call()
    with pytest.raises(ValueError, match="square"):
        tpd.resident_adapdm_dsvm(q[:, :16], lab, 1.0, 1.0, 5.0, 1e-5, 5)
    with pytest.raises(ValueError, match="n_true"):
        tpd.resident_cv_dsvm(q, lab, 1.0, 0.1, 0.1, 1e-5, 5, n_true=129)
    with pytest.raises(ValueError, match="maxit"):
        tpd.resident_cv_dsvm(q, lab, 1.0, 0.1, 0.1, 1e-5, -1)
    with pytest.raises(ValueError, match="at least one"):
        tpd.resident_adapdm_dsvm_sweep(q, lab, 1.0, [], 5.0, 1e-5, 5)
    with pytest.raises(ValueError, match="labels"):
        tpd.resident_cv_dsvm(q, lab[:64], 1.0, 0.1, 0.1, 1e-5, 5)
    assert [tpd.hist_len(m) for m in (0, 1, 128, 129)] == [0, 128, 128, 256]


def test_k6_zero_iterations_match_jax():
    q, _, lab, n, na, _ = pd_kernel_case()
    want = jr.resident_adapdm_dsvm(jnp.asarray(q), jnp.asarray(lab), 0.1, 1.0, na, 0.0, 0,
                                   n_true=n, interpret=True)
    got = tpd.resident_adapdm_dsvm(t64(q), t64(lab), 0.1, 1.0, na, 0.0, 0, n_true=n)
    assert int(got[1]) == int(want[1]) == 0 and not bool(got[3])
    assert float(got[2]) == float(want[2]) == float("inf")
    _close(got[0], want[0], rtol=0, atol=0)


# -- the driver ------------------------------------------------------------------------------


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


DRIVER_NAMES = ([f"AdaPDM (t={t})" for t in tdriver.T_VALUES]
                + [f"Malitsky-Pock (t={t})" for t in tdriver.T_VALUES] + ["Condat-Vu"])


@pytest.mark.parametrize("path", ["default", "resident"])
def test_driver_jsonl_matches_jax(tmp_path, capsys, no_download, path):
    """heart_scale's stand-in (270x13), C 0.1, maxit 80, f64, against the JAX
    driver's JSONL: all 25 rows (AdaPDM, Malitsky-Pock, Condat-Vu), in JAX's order,
    row for row, and the meta rows' wall_s keys and fast_methods. The JAX
    ``--resident`` side runs its kernels in interpret mode. Measured: every
    Malitsky-Pock row (the raw form, f64's default) matched to rtol 1e-9 through all
    80 iterations on both paths, so they are held over the whole run."""
    args = ["--datasets", "heart_scale", "--C", "0.1", "--maxit", "80", "--no-plot"]
    args += ["--resident"] if path == "resident" else []
    jdriver.main(["--cpu", "--outdir", str(tmp_path / "jax"), *args])
    capsys.readouterr()
    tdriver.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    out = capsys.readouterr().out
    assert "not ported" not in out and "falling back" not in out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "heart_scale_C_0.1.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "heart_scale_C_0.1.jsonl")
    jby, tby = {}, {}
    for rows, by in ((jrows, jby), (trows, tby)):
        for r in rows:
            if "it" in r:
                by.setdefault(r["method"], []).append(r)
    assert list(tby) == list(jby) == DRIVER_NAMES
    for name in DRIVER_NAMES:
        rows, want = tby[name], jby[name]
        assert len(rows) == len(want) == 80, name
        for rt, rj in zip(rows, want):
            assert list(rt) == list(rj) == tdriver.KEYS
            assert (rt["method"], rt["it"], rt["f_evals"]) == (rj["method"], rj["it"],
                                                               rj["f_evals"])
            assert rt["norm_res"] == pytest.approx(rj["norm_res"], rel=1e-9), (name, rt["it"])
    # the linesearch halved: f_evals is not the one-trial schedule 2 it
    assert max(r["f_evals"] - 2 * r["it"] for n_ in DRIVER_NAMES if n_.startswith("Mal")
               for r in tby[n_]) > 0
    tmeta = [r for r in trows if "it" not in r]
    jmeta = [r for r in jrows if "it" not in r]
    assert [list(r) for r in tmeta] == [list(r) for r in jmeta] == [
        ["wall_s", "fast_path", "fast_methods"], ["data_source"]]
    assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == path
    assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"])
    assert tmeta[0]["fast_methods"] == jmeta[0]["fast_methods"]
    if path == "resident":
        assert list(tmeta[0]["wall_s"]) == ["AdaPDM t-sweep (resident)",
                                            "MP t-sweep (resident)", "Condat-Vu"]
        assert tmeta[0]["fast_methods"] == tdriver.FAST_METHODS == list(tmeta[0]["wall_s"])
    else:
        assert list(tmeta[0]["wall_s"]) == ["AdaPDM t-sweep", "MP t-sweep", "Condat-Vu"]
        assert tmeta[0]["fast_methods"] == []
    assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}


def test_driver_routes_dense_and_factored_as_jax():
    """The resident inputs: the dense Gram where itemsize * n_pad^2 <= 24 MiB,
    else B padded to (n_pad, d_pad); the CPU falls back where neither fits."""
    rng = np.random.default_rng(0)
    for (n, d), dtype, want in (((270, 13), F64, False), ((1243, 21), torch.float32, False),
                                ((8124, 112), torch.float32, True),
                                ((8124, 112), F64, True)):
        dyx = rng.standard_normal((n, d))
        lab = np.where(rng.standard_normal(n) > 0, 1.0, -1.0)
        q, lab_pad, factored = tdriver.resident_inputs(dyx, lab, dtype, "cpu")
        n_pad = -(-n // 128) * 128
        assert factored == want and q.dtype == lab_pad.dtype == dtype
        assert q.shape == ((n_pad, 128) if want else (n_pad, n_pad)) and lab_pad.shape == (n_pad,)
        assert not bool(lab_pad[n:].any())
        if not want:
            _close(q[:n, :n], dyx @ dyx.T, rtol=1e-6 if dtype == torch.float32 else 1e-12,
                   atol=1e-4 if dtype == torch.float32 else 1e-12)
    # 13056 x 256 f64 is 26.7 MB: neither form fits, and the CPU takes the engine
    assert tdriver.resident_inputs(np.zeros((13000, 200)), np.ones(13000), F64, "cpu") is None


def test_driver_refuses_cuda_without_a_card(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdriver.main(["--outdir", str(tmp_path), "--datasets", "heart_scale", "--no-plot"])
