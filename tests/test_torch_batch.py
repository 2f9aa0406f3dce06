"""The batched solves of the PyTorch port against the JAX package, on the same
numpy inputs (f64 on the CPU): K2b's plain version (``resident_adapgm_batch``)
and ``solvers/batch.py`` (``batch_solve``, ``regularization_path``).

The JAX side runs its Pallas kernel ``resident_adapgm_batch`` in interpret
mode, as tests/test_kernels.py does. The CUDA kernel itself is tested on the
card (tests/test_torch_cuda.py) and by chip_smoke.py.

Tolerances are K2's (tests/test_torch_resident.py): the two sides sum in
different orders and the adaptive rules amplify that, so x is held to 1e-9
only on solves of at most 20 iterations, and converged solves to the same
solution (atol 1e-6) at iteration counts within max(25, 10%).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares as JLeastSquares
from adaprox_tpu.ops import resident as jr
from adaprox_tpu.solvers import batch as jb
import adaprox_tpu_torch as apt
from adaprox_tpu_torch.models.synthetic import random_lasso
from adaprox_tpu_torch.ops import resident as tr
from adaprox_tpu_torch.solvers import batch as tb

F64 = torch.float64


def _lasso_batch():
    """tests/test_kernels.py's four instances: random_lasso(64, 128, 8) at seeds
    0-3 with lam 1, 0.5, 2, 1 and gamma0 = 1 / ||A||^2."""
    mats, rhs, scal = [], [], []
    for seed, lam in [(0, 1.0), (1, 0.5), (2, 2.0), (3, 1.0)]:
        prob = random_lasso(m=64, n=128, pfactor=8, seed=seed)
        mats.append(prob.a)
        rhs.append(prob.b)
        scal.append([1 / float(np.linalg.norm(prob.a, 2) ** 2), 1e-5, lam, 0.0])
    return np.stack(mats), np.stack(rhs), np.asarray(scal)


def _logreg_batch():
    """Four logistic problems at 64x128 with labels in {0, 1}; the last column
    of each is the bias's ones column."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 64, 128)) / 8
    a[:, :, -1] = 1.0
    y = (rng.uniform(size=(4, 64)) < 0.5).astype(np.float64)
    scal = np.asarray([[4.0, 1e-6, lam, 0.0] for lam in (0.01, 0.02, 0.005, 0.01)])
    return a, y, scal


def _cubic_batch():
    """Four cubic models 0.5 x'Hx + q'x + (c/6)||x||^3 at n = 128, H symmetric
    positive definite, c in the fifth scal column."""
    rng = np.random.default_rng(11)
    mats, rhs, scal = [], [], []
    for c in (1.0, 0.5, 2.0, 0.25):
        g = rng.standard_normal((128, 128)) / 16
        h = g.T @ g + 0.1 * np.eye(128)
        mats.append(h)
        rhs.append(rng.standard_normal(128))
        scal.append([1 / float(np.linalg.norm(h, 2)), 1e-6, 0.0, 0.0, c])
    return np.stack(mats), np.stack(rhs), np.asarray(scal)


CASES = {"ls": (_lasso_batch, {}), "logreg": (_logreg_batch, {}),
         "cubic": (_cubic_batch, {"prox_kind": "zero"})}


def _both(a, b, scal, maxit, **kw):
    """The same batch through JAX's kernel (interpret mode) and the port."""
    x0 = np.zeros((a.shape[0], a.shape[2]))
    oj = jr.resident_adapgm_batch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x0),
                                  jnp.asarray(scal), maxit, interpret=True, **kw)
    ot = tr.resident_adapgm_batch(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(x0), torch.from_numpy(scal), maxit, **kw)
    return [np_of(v) for v in oj], [np_of(v) for v in ot]


@pytest.mark.parametrize("obj", sorted(CASES))
@pytest.mark.parametrize("rule,momentum", [("adapgm", False), ("mm", False),
                                           ("fixed", False), ("fixed", True)])
def test_batch_short_solves_match_jax(obj, rule, momentum):
    """20 iterations at tol 0: inside the horizon, x to 1e-9 of max|x|."""
    make, kw = CASES[obj]
    a, b, scal = make()
    launches = tr.resident_adapgm_batch.launches
    oj, ot = _both(a, b, scal, 20, obj_kind=obj, rule_kind=rule, momentum=momentum, **kw)
    assert tr.resident_adapgm_batch.launches == launches  # CPU tensors: the plain version
    assert ot[0].shape == (4, a.shape[2]) and ot[1].dtype == np.int32
    assert ot[2].dtype == np.float64 and ot[3].dtype == np.bool_
    np.testing.assert_array_equal(ot[1], oj[1])
    np.testing.assert_array_equal(ot[3], oj[3])
    # norm_res travels through the kernel's f32 stats on both sides
    np.testing.assert_allclose(ot[2], oj[2], rtol=1e-6)
    for i in range(4):
        np.testing.assert_allclose(ot[0][i], oj[0][i], rtol=1e-9,
                                   atol=1e-9 * np.abs(oj[0][i]).max())


@pytest.mark.parametrize("obj", sorted(CASES))
def test_batch_converges_to_jax_solution(obj):
    """Solved to tol 1e-9 (the logistic loss is flat: at 1e-6 its x were 1e-5
    apart), the two sides stop near each other at the same solution."""
    make, kw = CASES[obj]
    a, b, scal = make()
    scal[:, 1] = 1e-9
    oj, ot = _both(a, b, scal, 5000, obj_kind=obj, **kw)
    assert ot[3].all() and oj[3].all()
    for i in range(4):
        numit = int(oj[1][i])
        assert numit < 5000 and abs(int(ot[1][i]) - numit) <= max(25, numit // 10)
        np.testing.assert_allclose(ot[0][i], oj[0][i], rtol=0, atol=1e-6)


def test_batch_logreg_m_true_matches_jax_single_solves():
    """JAX's batch entry cannot take a logreg m_true (its jit traces it, and the
    mean's divisor must be concrete), so the port's instances with m_true are
    held against JAX's single K2 solve of each instance."""
    a, b, scal = _logreg_batch()
    ot = tr.resident_adapgm_batch(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.zeros(4, 128, dtype=F64), torch.from_numpy(scal), 20,
                                  obj_kind="logreg", m_true=60.0)
    with pytest.raises(Exception, match="m_true"):
        jr.resident_adapgm_batch(jnp.asarray(a), jnp.asarray(b), jnp.zeros((4, 128)),
                                 jnp.asarray(scal), 20, obj_kind="logreg", m_true=60.0,
                                 interpret=True)
    for i in range(4):
        oj = jr.resident_adapgm(jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.zeros(128),
                                scal[i, 0], scal[i, 1], 20, p1=scal[i, 2], obj_kind="logreg",
                                m_true=60.0, interpret=True)
        assert int(ot[1][i]) == int(oj[1]) == 20
        np.testing.assert_allclose(np_of(ot[0][i]), np_of(oj[0]), rtol=1e-9,
                                   atol=1e-9 * np.abs(np_of(oj[0])).max())


@pytest.mark.parametrize("obj,m_true", [("ls", None), ("logreg", None), ("logreg", 60.0),
                                        ("cubic", None)])
def test_batch_instances_equal_single_solves(obj, m_true):
    """Instance i is the port's resident_adapgm with its arguments, bit for bit;
    a (B, 4) table is the (B, 5) one with cube_c = 0."""
    make, kw = CASES[obj]
    a, b, scal = (torch.from_numpy(v) for v in make())
    x0 = torch.zeros(4, a.shape[2], dtype=F64)
    out = tr.resident_adapgm_batch(a, b, x0, scal, 300, obj_kind=obj, m_true=m_true, **kw)
    for i in range(4):
        sc = scal[i].tolist()
        one = tr.resident_adapgm(a[i], b[i], x0[i], sc[0], sc[1], 300, p1=sc[2], p2=sc[3],
                                 obj_kind=obj, m_true=m_true,
                                 cube_c=sc[4] if scal.shape[1] == 5 else 0.0, **kw)
        for got, want in zip(out, one):
            assert torch.equal(got[i], want)
    if scal.shape[1] == 4:
        five = torch.cat([scal, torch.zeros(4, 1, dtype=F64)], 1)
        for u, w in zip(out, tr.resident_adapgm_batch(a, b, x0, five, 300, obj_kind=obj,
                                                      m_true=m_true, **kw)):
            assert torch.equal(u, w)


def test_batch_shared_a_equals_materialized():
    """One A expanded over the batch (stride 0) gives the materialized batch's
    bits: the regularization path's use."""
    a, b, scal = _lasso_batch()
    a0 = torch.from_numpy(a[0])
    shared = a0.expand(4, *a0.shape)
    assert shared.stride(0) == 0
    bb = torch.from_numpy(b[0]).expand(4, -1).contiguous()
    x0 = torch.zeros(4, 128, dtype=F64)
    sc = torch.from_numpy(scal)
    sc[:, 0] = sc[0, 0]
    got = tr.resident_adapgm_batch(shared, bb, x0, sc, 500)
    want = tr.resident_adapgm_batch(shared.contiguous(), bb, x0, sc, 500)
    for u, w in zip(got, want):
        assert torch.equal(u, w)


def test_batch_zero_iterations_match_jax():
    a, b, scal = _lasso_batch()
    oj, ot = _both(a, b, scal, 0)
    np.testing.assert_array_equal(ot[1], oj[1])
    assert (ot[1] == 0).all() and np.isinf(ot[2]).all() and not ot[3].any()
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("kw,match", [
    (dict(rule_kind="dynamic"), "dynamic"),
    (dict(rule_kind="nope"), "must be one of"),
    (dict(prox_kind="nope"), "must be one of"),
    (dict(obj_kind="nope"), "must be one of"),
    (dict(obj_kind="cubic"), "square H"),
    (dict(scal=np.zeros((4, 3))), "scal must be"),
    (dict(scal=np.zeros((3, 4))), "scal must be"),
    (dict(b=np.zeros((3, 64))), "B >= 1"),
    (dict(a=np.zeros((0, 64, 128)), b=np.zeros((0, 64)), x0=np.zeros((0, 128)),
          scal=np.zeros((0, 4))), "B >= 1"),
    (dict(a=np.zeros((64, 128))), r"a \(B, m, n\)"),
    (dict(b=np.zeros((4, 63))), "shape mismatch"),
])
def test_batch_refusals(kw, match):
    a, b, scal = _lasso_batch()
    args = dict(a=a, b=b, x0=np.zeros((4, 128)), scal=scal)
    kw = dict(kw)
    call = {k: torch.from_numpy(np.asarray(kw.pop(k, v))) for k, v in args.items()}
    with pytest.raises(ValueError, match=match):
        tr.resident_adapgm_batch(call["a"], call["b"], call["x0"], call["scal"], 5, **kw)


# -- solvers/batch.py ----------------------------------------------------------------

# The JAX package's own batch tests (tests/test_checkpoint_batch.py) take
# random_lasso(64, 128, 8, seed=2). At tol 1e-8 and maxit 5000 lam 1 and 2 converge
# (851 and 2404 iterations on both sides) and lam 0.1 and 0.5 run all 5000; x agreed
# to 1.3e-10 of max|x| (measured), so JAX's own tolerances hold: numit exact, x at
# rtol 1e-8. The history rows first drift past 1e-9 at iteration 36 (lam 0.5;
# 142, 40, 39 for the others), so rows are held over 30.
LAMS = [0.1, 0.5, 1.0, 2.0]
ROW_HORIZON = 30
RECORD_COLUMNS = ("gamma", "norm_res", "objective")
COUNT_COLUMNS = ("it", "f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
                 "At_evals", "valid")


@pytest.fixture(scope="module")
def path_problem():
    prob = random_lasso(m=64, n=128, pfactor=8, seed=2)
    lf = float(np.linalg.norm(prob.a, 2) ** 2)
    fj = JLeastSquares(a=jnp.asarray(prob.a), b=jnp.asarray(prob.b))
    ft = apt.LeastSquares(torch.from_numpy(prob.a), torch.from_numpy(prob.b))
    return fj, ft, lf


def _paths(path_problem, **kw):
    fj, ft, lf = path_problem
    rj = jb.regularization_path(jnp.zeros(128), f=fj, lams=jnp.asarray(LAMS), gamma=1 / lf,
                                **kw)
    rt = tb.regularization_path(torch.zeros(128, dtype=F64), f=ft, lams=LAMS, gamma=1 / lf,
                                **kw)
    return rj, rt


def test_regularization_path_matches_jax(path_problem):
    rj, rt = _paths(path_problem, tol=1e-8, maxit=5000)
    assert rt.name is None and rt.y is None and rt.records is None
    assert rt.x.shape == (4, 128) and rt.numit.shape == (4,)
    np.testing.assert_array_equal(np_of(rt.numit), np_of(rj.numit))
    assert np_of(rt.numit).tolist() == [5000, 5000, 851, 2404]
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-8, atol=1e-10)
    for k in rt.counters._fields:
        np.testing.assert_array_equal(np_of(getattr(rt.counters, k)),
                                      np_of(getattr(rj.counters, k)), err_msg=k)
    # the stopping residual of the converged slices is below tol on both sides
    assert (np_of(rt.norm_res)[2:] <= 1e-8).all() and (np_of(rj.norm_res)[2:] <= 1e-8).all()
    np.testing.assert_array_equal(np_of(rt.diag["rule_nan"]), np_of(rj.diag["rule_nan"]))


def test_regularization_path_records_match_jax(path_problem):
    """history=True: JAX's vmapped scan gives (B, maxit) rows with a valid mask;
    the port's valid rows line up with them, and its (B, rows) columns are padded
    with invalid zero rows to the longest slice."""
    rj, rt = _paths(path_problem, tol=1e-8, maxit=1000, history=True)
    valid_j = np_of(rj.records.valid)
    valid_t = np_of(rt.records.valid)
    assert valid_t.shape == (4, 1000)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert valid_t.sum(1).tolist() == np_of(rt.numit).tolist() == [1000, 1000, 851, 1000]
    for k in COUNT_COLUMNS:
        got, want = np_of(getattr(rt.records, k)), np_of(getattr(rj.records, k))
        np.testing.assert_array_equal(got[valid_t], want[valid_j], err_msg=k)
    for k in RECORD_COLUMNS:
        got, want = np_of(getattr(rt.records, k)), np_of(getattr(rj.records, k))
        np.testing.assert_allclose(got[:, :ROW_HORIZON], want[:, :ROW_HORIZON], rtol=1e-9,
                                   err_msg=k)
        assert (got[~valid_t] == 0).all()
    # the rows are those of each slice's own solve
    single = apt.adaptive_proxgrad(torch.zeros(128, dtype=F64), f=path_problem[1],
                                   g=apt.L1Norm(torch.tensor(LAMS[2], dtype=F64)),
                                   rule=apt.AdaPGMRule(gamma=1 / path_problem[2]), tol=1e-8,
                                   maxit=1000, history=True)
    for k in RECORD_COLUMNS + COUNT_COLUMNS:
        assert torch.equal(getattr(rt.records, k)[2, :single.numit],
                           getattr(single.records, k)), k


def test_batch_solve_matches_jax(path_problem):
    """tests/test_checkpoint_batch.py's batch over two step sizes (different
    convergence speeds): the port's slices are their single solves bit for bit,
    and JAX's batched solves converge to the same points."""
    fj, ft, lf = path_problem

    def solve_j(gamma):
        return ap.adaptive_proxgrad(jnp.zeros(128), f=fj, g=ap.L1Norm(lam=1.0),
                                    rule=ap.AdaPGMRule(gamma=gamma), tol=1e-6, maxit=4000)

    def solve_t(gamma):
        return apt.adaptive_proxgrad(torch.zeros(128, dtype=F64), f=ft, g=apt.L1Norm(1.0),
                                     rule=apt.AdaPGMRule(gamma=gamma), tol=1e-6, maxit=4000)

    gammas = np.asarray([1 / lf, 0.1 / lf])
    rj = jb.batch_solve(solve_j, jnp.asarray(gammas))
    rt = tb.batch_solve(solve_t, torch.from_numpy(gammas))
    for i in range(2):
        single = solve_t(torch.from_numpy(gammas)[i])
        assert int(rt.numit[i]) == single.numit
        assert torch.equal(rt.x[i], single.x) and torch.equal(rt.norm_res[i], single.norm_res)
        numit = int(rj.numit[i])
        assert abs(int(rt.numit[i]) - numit) <= max(25, numit // 10)
        np.testing.assert_allclose(np_of(rt.x[i]), np_of(rj.x[i]), rtol=0, atol=1e-6)


def test_batch_solve_slices_every_leaf():
    """A pytree of batched inputs (a dict holding a tensor and a tuple) is sliced
    leaf by leaf; a missing leading axis is refused."""
    seen = []

    def solve(sl):
        seen.append((float(sl["lam"]), tuple(float(v) for v in sl["pair"])))
        x = torch.full((3,), float(sl["lam"]))
        return apt.SolveResult(x=x, y=None, numit=int(sl["lam"]), norm_res=x.sum(),
                               counters=apt.Counters(f_evals=2), name="dropped")

    out = tb.batch_solve(solve, {"lam": torch.tensor([1.0, 2.0]),
                                 "pair": (np.asarray([3.0, 4.0]), torch.tensor([5.0, 6.0]))})
    assert seen == [(1.0, (3.0, 5.0)), (2.0, (4.0, 6.0))]
    assert out.name is None and out.y is None and out.numit.tolist() == [1, 2]
    assert out.x.shape == (2, 3) and out.counters.f_evals.tolist() == [2, 2]
    with pytest.raises(ValueError, match="leading axis"):
        tb.batch_solve(solve, {"lam": torch.zeros(0)})
