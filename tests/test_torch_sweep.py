"""The rule sweep K2c, the momentum body of K2 and ``fixed_nesterov`` of the
PyTorch port against the JAX package, on the same numpy inputs (f64 on the
CPU).

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's ``resident_adapgm`` and
``resident_rule_sweep`` take their plain versions on CPU tensors. The CUDA
kernels are tested on the card (tests/test_torch_cuda.py) and by
chip_smoke.py.

About the horizons. The two sides sum in different orders, so they differ by
~1e-16 after the first matvec. The momentum body with its fixed step does not
amplify that the way the adaptive rules do: on ``random_lasso(64, 128, 8,
seed=3)`` its history rows stayed within 2.1e-12 (l1), 1.9e-12 (elastic),
5.6e-13 (zero) and 1.5e-11 (box, past 1e-11 from iteration 275 on) of JAX's
over 300 iterations, and ``fixed_nesterov`` within 6.4e-12 over 500
(measured on the CPU in f64). So they are held to rtol 1e-9 over 200 iterations (500 for
the engine), 100x inside the drift. The final x agreed to 7e-15 of max|x|
after 20-100 iterations. In a sweep each rule row keeps its rule's horizon
(tests/test_torch_resident.py): the adaptive rows drift past 1e-11 from
iteration 32 (AdaPGM) and 36 (MM) on, so they are held over 30.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lasso_case, np_of

import adaprox_tpu as ap
import adaprox_tpu.utils.logging as jlog
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.models.objectives import LeastSquares as JLeastSquares
from adaprox_tpu.models.objectives import Quadratic as JQuadratic
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import lasso as tlasso
from adaprox_tpu_torch.models.synthetic import random_lasso
from adaprox_tpu_torch.ops import resident as tr
from adaprox_tpu_torch.ops.oracles import SmoothOracle

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective")
MOMENTUM_HORIZON = 200
# the specs of tests/test_kernels.py::test_resident_rule_sweep_bit_exact: tol and
# cap per row, a momentum row; each row's horizon
SWEEP_SPECS = [("adapgm", False, 1e-9, 200), ("fixed", False, 0.0, 100),
               ("mm", False, 0.0, 100), ("fixed", True, 0.0, 100)]
SWEEP_HORIZON = (30, 100, 30, 100)


def _case():
    prob = random_lasso(m=64, n=128, pfactor=8, seed=3)
    return prob.a, prob.b, 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)


def _t(a, b):
    return torch.from_numpy(a), torch.from_numpy(b), torch.zeros(a.shape[1], dtype=F64)


def _both(a, b, gamma0, tol, maxit, **kw):
    """The same solve through JAX's kernel (interpret mode) and the port."""
    oj = jr.resident_adapgm(jnp.asarray(a), jnp.asarray(b), jnp.zeros(a.shape[1]), gamma0, tol,
                            maxit, interpret=True, **kw)
    ot = tr.resident_adapgm(*_t(a, b), gamma0, tol, maxit, **kw)
    return [np_of(v) for v in oj], [np_of(v) for v in ot]


def _sweep_rows(gamma0):
    return jr.rule_rows([(gamma0, rule, mom, tol, cap) for rule, mom, tol, cap in SWEEP_SPECS])


# -- the momentum body of K2 --------------------------------------------------------


@pytest.mark.parametrize("prox,p1,p2", [("l1", 1.0, 0.0), ("box", -0.1, 0.1),
                                        ("elastic", 1.0, 0.5), ("zero", 0.0, 0.0)])
def test_momentum_rows_match_jax(prox, p1, p2):
    a, b, gamma0 = _case()
    kw = dict(prox_kind=prox, p1=p1, p2=p2, rule_kind="fixed", momentum=True)
    launches = tr.resident_adapgm.launches
    oj, ot = _both(a, b, gamma0, 0.0, MOMENTUM_HORIZON, record=True, **kw)
    assert tr.resident_adapgm.launches == launches  # CPU tensors: the plain version
    assert int(ot[1]) == int(oj[1]) == MOMENTUM_HORIZON and not ot[3] and not oj[3]
    for k, name in enumerate(HIST, start=4):
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-9, err_msg=name)
    assert np.all(ot[4] == gamma0)  # the fixed step
    # x, numit and norm_res of a solve that stops inside the horizon
    oj, ot = _both(a, b, gamma0, 0.0, 30, **kw)
    assert int(ot[1]) == int(oj[1]) == 30 and bool(ot[3]) == bool(oj[3])
    # norm_res travels through the kernel's f32 stats on both sides
    assert float(ot[2]) == pytest.approx(float(oj[2]), rel=1e-6)
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-9, atol=1e-9 * np.abs(oj[0]).max())


def test_momentum_converges_like_jax():
    """Solved to tol 1e-6: both stop at the same iteration (3175, measured)."""
    a, b, gamma0 = _case()
    oj, ot = _both(a, b, gamma0, 1e-6, 5000, p1=1.0, momentum=True)
    assert bool(ot[3]) and bool(oj[3]) and int(ot[1]) == int(oj[1]) < 5000
    assert float(ot[2]) <= 1e-6
    np.testing.assert_allclose(ot[0], oj[0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("rule", ["mm", "adapgm"])
def test_momentum_ignores_the_rule(rule):
    a, b, gamma0 = _case()
    args = (*_t(a, b), gamma0, 0.0, 40)
    fixed = tr.resident_adapgm(*args, p1=1.0, momentum=True, record=True)
    other = tr.resident_adapgm(*args, p1=1.0, rule_kind=rule, momentum=True, record=True)
    assert all(torch.equal(u, w) for u, w in zip(fixed, other))


def test_momentum_zero_iterations_match_jax():
    a, b, gamma0 = _case()
    oj, ot = _both(a, b, gamma0, 1e-6, 0, p1=1.0, momentum=True)
    assert int(ot[1]) == int(oj[1]) == 0 and float(ot[2]) == float(oj[2]) == np.inf
    np.testing.assert_array_equal(ot[0], oj[0])  # x0 itself


# -- K2c, the rule sweep ----------------------------------------------------------------


def test_rule_sweep_matches_jax():
    a, b, gamma0 = _case()
    rows = _sweep_rows(gamma0)
    xj, itj, rj, cj, hj = jr.resident_rule_sweep(jnp.asarray(a), jnp.asarray(b), jnp.zeros(128),
                                                 rows, 0.0, 200, prox_kind="l1", p1=1.0,
                                                 interpret=True)
    launches = tr.resident_rule_sweep.launches
    xt, itt, rt, ct, ht = tr.resident_rule_sweep(*_t(a, b), rows, 0.0, 200, prox_kind="l1",
                                                 p1=1.0)
    assert tr.resident_rule_sweep.launches == launches  # CPU tensors: the plain version
    assert xt.shape == (4, 128) and itt.dtype == torch.int32 and ct.dtype == torch.bool
    assert all(h.shape == (4, 200) and h.dtype == F64 for h in ht)
    for j, ((rule, mom, tol, cap), horizon) in enumerate(zip(SWEEP_SPECS, SWEEP_HORIZON)):
        numit = int(itj[j])
        # the adaptive rows stop where tol lands: within JAX's own band
        assert abs(int(itt[j]) - numit) <= max(25, numit // 10), (rule, mom)
        assert int(itt[j]) <= cap and bool(ct[j]) == bool(cj[j])
        for k, name in enumerate(HIST):
            np.testing.assert_allclose(np_of(ht[k][j])[:horizon], np_of(hj[k][j])[:horizon],
                                       rtol=1e-9, err_msg=f"{rule} {mom} {name}")
            assert not np_of(ht[k][j])[cap:].any()  # zero past the row's cap
        if horizon == cap:
            np.testing.assert_allclose(np_of(xt[j]), np_of(xj[j]), rtol=1e-9,
                                       atol=1e-9 * np.abs(np_of(xj[j])).max())


def test_sweep_rows_equal_single_plain_calls():
    """Row j of a sweep is the single solve with row j's arguments, bit for
    bit (the CPU side of tests/test_kernels.py::test_resident_rule_sweep_bit_exact)."""
    a, b, gamma0 = _case()
    sweep = tr.resident_rule_sweep(*_t(a, b), _sweep_rows(gamma0), 0.0, 200, prox_kind="l1",
                                   p1=1.0)
    for j, (rule, mom, tol, cap) in enumerate(SWEEP_SPECS):
        one = tr.resident_adapgm(*_t(a, b), gamma0, tol, cap, prox_kind="l1", p1=1.0,
                                 rule_kind=rule, momentum=mom, record=True)
        for k in range(4):
            assert torch.equal(sweep[k][j], one[k]), (rule, mom, k)
        for k in range(3):
            assert torch.equal(sweep[4][k][j][:cap], one[4 + k]), (rule, mom, HIST[k])


@pytest.mark.parametrize("kind", ["3-tuples", "5-tuples", "mixed"])
def test_rule_rows_match_jax(kind):
    g = 0.01
    specs = {"3-tuples": [(g, "fixed", False), (g, "fixed", True), (g, "mm", False),
                          (g, "adapgm", False)],
             "5-tuples": [(g, "adapgm", False, 1e-9, 200), (g, "fixed", True, 0.0, 100)],
             "mixed": [(g, "mm", 0, 1e-5, 7), (2 * g, "adapgm", 1)]}[kind]
    want = jr.rule_rows(specs, tol=1e-7, maxit=300)
    got = tr.rule_rows(specs, tol=1e-7, maxit=300)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(tol=1e-7), dict(maxit=300)])
def test_rule_rows_need_tol_and_maxit_for_3_tuples(kw):
    specs = [(0.01, "fixed", False)]
    for mod in (jr, tr):
        with pytest.raises(ValueError, match="explicit tol= and maxit="):
            mod.rule_rows(specs, **kw)


def test_momentum_records_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    maxit, numit = 40, 23
    hists = [np.where(np.arange(maxit) < numit, rng.standard_normal(maxit), 0.0)
             for _ in HIST]
    rj = jr.resident_records(jnp.int32(numit), *(jnp.asarray(h) for h in hists), maxit=maxit,
                             momentum=True)
    rt = tr.resident_records(torch.tensor(numit, dtype=torch.int32),
                             *(torch.from_numpy(h) for h in hists), maxit=maxit, momentum=True)
    for k in rt._fields:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), err_msg=k)
    assert np.array_equal(np_of(rt.f_evals), np.arange(1, maxit + 1))  # no warm-up
    nj, lj = jlog.write_records_jsonl(tmp_path / "j.jsonl", rj, "m")
    nt, lt = tlog.write_records_jsonl(tmp_path / "t.jsonl", rt.numpy(), "m")
    assert (nt, lt) == (nj, lj) and nt == numit
    assert tlog.read_jsonl(tmp_path / "t.jsonl") == jlog.read_jsonl(tmp_path / "j.jsonl")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_sweep_refuses_sub_32_bit_iterates(dtype):
    a, b, gamma0 = _case()
    with pytest.raises(ValueError, match=">= 32-bit iterates"):
        tr.resident_rule_sweep(torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
                               torch.zeros(128, dtype=dtype), _sweep_rows(gamma0), 0.0, 200)


@pytest.mark.parametrize("rows,match", [
    ([[0.01, 0, 0, 0.0, 201]], "cap must be an integer in"),  # past maxit
    ([[0.01, 0, 0, 0.0, -1]], "cap must be an integer in"),
    ([[0.01, 0, 0, 0.0, 10.5]], "cap must be an integer in"),
    ([[0.01, 3, 0, 0.0, 10]], "rule_idx must be"),
    ([[0.01, 0, 0, 0.0]], r"must be \(R >= 1, 5\)"),
    (np.zeros((0, 5)), r"must be \(R >= 1, 5\)"),
])
def test_sweep_refuses_bad_rows(rows, match):
    a, b, _ = _case()
    with pytest.raises(ValueError, match=match):
        tr.resident_rule_sweep(*_t(a, b), np.asarray(rows), 0.0, 200)


# logreg and cubic are ported (tests/test_torch_logreg.py, tests/test_torch_cubic.py);
# cubic refuses an H that is not square
@pytest.mark.parametrize("kw,exc,match", [
    (dict(obj_kind="cubic", cube_c=2.0), ValueError, "square H"),
    (dict(obj_kind="cubic"), ValueError, "square H"),
    (dict(prox_kind="nope"), ValueError, "must be one of"),
])
def test_sweep_refuses_what_is_not_ported(kw, exc, match):
    a, b, gamma0 = _case()
    with pytest.raises(exc, match=match):
        tr.resident_rule_sweep(*_t(a, b), _sweep_rows(gamma0), 0.0, 200, **kw)


def test_single_entry_refuses_the_dynamic_rule():
    a, b, gamma0 = _case()
    with pytest.raises(ValueError, match="resident_rule_sweep"):
        tr.resident_adapgm(*_t(a, b), gamma0, 0.0, 5, rule_kind="dynamic")


# -- fixed_nesterov ---------------------------------------------------------------------


def test_fixed_nesterov_lasso_matches_jax():
    a, b, lam, _, gamma0 = lasso_case(64, 128, 8, 3)
    rj = ap.fixed_nesterov(jnp.zeros(128), f=JLeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)),
                           g=ap.L1Norm(lam=lam), gamma=gamma0, tol=0.0, maxit=500, history=True)
    rt = apt.fixed_nesterov(torch.zeros(128, dtype=F64),
                            f=apt.LeastSquares(torch.from_numpy(a), torch.from_numpy(b)),
                            g=apt.L1Norm(lam), gamma=gamma0, tol=0.0, maxit=500, history=True)
    assert rt.name == rj.name == "Fixed Nesterov"
    assert int(rt.numit) == int(rj.numit) == 500 and rt.counters[:3] == (500, 500, 500)
    for k in rt.records._fields:
        got, want = np_of(getattr(rt.records, k)), np_of(getattr(rj.records, k))
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)


class _Quadratic(SmoothOracle):
    """f(x) = 0.5 x'Qx + q'x, as the JAX package's ``Quadratic`` (aux = Qx)."""

    def __init__(self, q_mat, q_vec):
        self.q_mat, self.q_vec = q_mat, q_vec

    def value_and_aux(self, x):
        qx = torch.mv(self.q_mat, x)
        return 0.5 * torch.dot(x, qx) + torch.dot(x, self.q_vec), qx

    def grad_from_aux(self, x, qx):
        return qx + self.q_vec


def test_fixed_nesterov_strongly_convex_matches_jax():
    """tests/test_misc.py::test_fixed_nesterov_strongly_convex on both sides:
    muf > 0 engages the q-based momentum and converges in fewer iterations.
    The two sides stop at the same iteration (measured)."""
    rng = np.random.default_rng(0)
    n = 40
    u = rng.standard_normal((n, n))
    q_mat = u.T @ u + 0.5 * np.eye(n)  # mu >= 0.5
    q_vec = rng.standard_normal(n)
    evals = np.linalg.eigvalsh(q_mat)
    lf, mu = float(evals[-1]), float(evals[0])
    fj = JQuadratic(q_mat=jnp.asarray(q_mat), q_vec=jnp.asarray(q_vec))
    ft = _Quadratic(torch.from_numpy(q_mat), torch.from_numpy(q_vec))
    kw = dict(gamma=1 / lf, tol=1e-10, maxit=20_000)
    res = {}
    for name, extra in (("plain", {}), ("strong", dict(muf=mu))):
        rj = ap.fixed_nesterov(jnp.zeros(n), f=fj, g=ap.Zero(), **kw, **extra)
        rt = apt.fixed_nesterov(torch.zeros(n, dtype=F64), f=ft, g=apt.Zero(), **kw, **extra)
        assert int(rt.numit) == int(rj.numit) < 20_000, name
        assert float(rt.norm_res) <= 1e-10
        np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)
        res[name] = rt
    assert int(res["strong"].numit) < int(res["plain"].numit)
    np.testing.assert_allclose(np_of(res["strong"].x), np_of(res["plain"].x), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(),                                  # neither gamma nor Lf
    dict(gamma=1.0, Lf=1.0),                 # both
    dict(gamma=1.0, muf=2.0),                # q = 2 >= 1
    dict(gamma=0.5, muf=1.0, theta=2.0),     # theta > 1/sqrt(q) = 1.41
    dict(gamma=0.5, theta=-0.5),             # theta < 0
])
def test_fixed_nesterov_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        ap.fixed_nesterov(jnp.zeros(2), f=JQuadratic(q_mat=jnp.eye(2), q_vec=jnp.zeros(2)),
                          g=ap.Zero(), **kw)
    with pytest.raises(ValueError):
        apt.fixed_nesterov(torch.zeros(2, dtype=F64),
                           f=_Quadratic(torch.eye(2, dtype=F64), torch.zeros(2, dtype=F64)),
                           g=apt.Zero(), **kw)


@pytest.mark.parametrize("opt", ["resume_state", "scalar_dtype", "it_cap"])
def test_fixed_nesterov_refuses_what_is_not_ported(opt):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        apt.fixed_nesterov(torch.zeros(2, dtype=F64),
                           f=_Quadratic(torch.eye(2, dtype=F64), torch.zeros(2, dtype=F64)),
                           g=apt.Zero(), gamma=0.5, **{opt: 1})


# -- the lasso driver -------------------------------------------------------------------


def test_lasso_resident_is_one_sweep(tmp_path, monkeypatch):
    """``--resident`` runs the four rule rows as one rule-sweep call, the four
    backtracking rows as one backtracking-sweep call and aGRAAL as one
    resident_agraal call, and writes the two sweeps' walls in
    ``grid_total_s`` before the ``wall_s`` row (aGRAAL's wall is its own, as
    in JAX)."""
    calls, bt_calls, ag_calls = [], [], []
    sweep, bt_sweep = tlasso.resident_rule_sweep, tlasso.resident_bt_sweep
    ag = tlasso.resident_agraal

    def counting(*args, **kw):
        calls.append(args[3])
        return sweep(*args, **kw)

    def bt_counting(*args, **kw):
        bt_calls.append(args[3])
        return bt_sweep(*args, **kw)

    def ag_counting(*args, **kw):
        ag_calls.append(args[3])
        return ag(*args, **kw)

    monkeypatch.setattr(tlasso, "resident_rule_sweep", counting)
    monkeypatch.setattr(tlasso, "resident_bt_sweep", bt_counting)
    monkeypatch.setattr(tlasso, "resident_agraal", ag_counting)
    tlasso.main(["--outdir", str(tmp_path), "--resident", "--sizes", "64x128x8", "--maxit", "50",
                 "--no-plot", "--device", "cpu"])
    assert len(calls) == 1 and len(bt_calls) == 1 and len(ag_calls) == 1
    # the companion point: noise on the 128 unpadded coordinates
    assert bool((ag_calls[0] != 0).all())
    names = [name for name, _, _ in tlasso.RESIDENT_ROWS]
    bt_names = [name for name, _, _ in tlasso.BT_ROWS]
    np.testing.assert_array_equal(calls[0][:, 1:3], [[0, 0], [0, 1], [1, 0], [2, 0]])
    np.testing.assert_array_equal(bt_calls[0][:, 1:], [[1.0, 0], [1.5, 0], [2.0, 0], [1.0, 1]])
    rows = tlog.read_jsonl(tmp_path / "lasso_64_128_8.jsonl")
    methods = [r["method"] for r in rows if r.get("method")]
    assert list(dict.fromkeys(methods)) == names[:1] + bt_names + names[1:] + ["aGRAAL"]
    grid, meta = rows[-2], rows[-1]
    assert list(grid) == ["grid_total_s"] and list(grid["grid_total_s"]) == ["bt sweep",
                                                                           "rule sweep"]
    assert list(meta) == ["wall_s", "fast_path", "fast_methods"]
    assert list(meta["wall_s"]) == bt_names + names + ["aGRAAL"]
    assert meta["fast_methods"] == sorted(names + bt_names + ["aGRAAL"])
    # each row's share of its sweep's wall; both columns are rounded to 1e-4 s
    for group, key in ((names, "rule sweep"), (bt_names, "bt sweep")):
        total = grid["grid_total_s"][key]
        assert all(abs(meta["wall_s"][name] - total / 4) <= 1e-4 for name in group)
