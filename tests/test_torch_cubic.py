"""The cubic-model path of the PyTorch port against the JAX package, on the
same numpy inputs (f64 on the CPU unless a test says otherwise): the
logistic Hessian of the cubic driver (a numpy-only copy), ``Cubic`` and
``WorstQuadratic``, the engine on both objectives, the cubic objective of K2
and K2c (plain versions), and the ``cubic_sparse_logreg`` and
``nesterov_worst_case`` drivers.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's wrappers take their plain versions on
CPU tensors. The CUDA kernels are tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py.

No test here reaches the network: the JAX package's dataset loader would try
to download a missing file, so its download is replaced by one that fails
as it does without a network (``no_download``).

About the horizons (see tests/test_torch_engine.py for the mechanism). The
two sides sum in different orders; the adaptive rules amplify that
difference through their curvature ratios, and the cubic term (c > 0) makes
it faster. Measured on the CPU in f64, the first relative difference past
1e-11 came at: K2 on the logistic-Hessian model below with c = 1, AdaPGM at
iteration 19 and MM at 31 (c = 0: AdaPGM at 56, MM never in 60); the
engine on the same model at 19 and 32, on the worst case below MM at 48 and
AdaPGM never in 300; the fixed step and the momentum body never.
On the drivers' rows, past 1e-9: the worst case's MM row at iteration 59 of
300 (every other row, the backtracking rows included, and every
cubic_sparse_logreg row on heart_scale agreed to the end, 13-70
iterations). Rows are held to rtol 1e-9 over
horizons below those.
"""

import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import cubic_sparse_logreg as jcubic
from adaprox_tpu.experiments import nesterov_worst_case as jworst
from adaprox_tpu.models.objectives import Cubic as JCubic
from adaprox_tpu.models.objectives import WorstQuadratic as JWorstQuadratic
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import cubic_sparse_logreg as tcubic
from adaprox_tpu_torch.experiments import nesterov_worst_case as tworst
from adaprox_tpu_torch.ops import resident as tr
from adaprox_tpu_torch.utils.datasets import load_or_synthesize

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective")


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def cubic_case(seed=0, n=128):
    """A logistic-Hessian-shaped cubic model (PSD, modest scale), as
    tests/test_kernels.py::_cubic_problem builds it."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((256, n)) / np.sqrt(n)
    sb = rng.random(256) / 256
    return feats.T @ (sb[:, None] * feats), rng.standard_normal(n) / n


def worst_dense(k, n, lip):
    """The worst case as the c = 0 cubic model, as the JAX driver builds it."""
    t = np.zeros((n, n))
    for i in range(k):
        t[i, i] = 2.0
        if i + 1 < k:
            t[i, i + 1] = t[i + 1, i] = -1.0
    q = np.zeros(n)
    q[0] = -lip / 4
    return lip / 4 * t, q


# -- the numpy-only Hessian and the objectives ------------------------------------------


@pytest.mark.parametrize("point", ["zero", "random"])
def test_logistic_hessian_is_bit_identical(point, no_download):
    x, y, _ = load_or_synthesize("heart_scale", labels=(0.0, 1.0))
    w = np.zeros(x.shape[1] + 1) if point == "zero" else gaussian(3, x.shape[1] + 1)
    want = jcubic.logistic_loss_grad_hessian(x, y, w)
    got = tcubic.logistic_loss_grad_hessian(x, y, w)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and u.shape == v.shape and u.tobytes() == v.tobytes()


@pytest.mark.parametrize("c", [0.0, 1.0, 3.5])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cubic_matches_jax(dtype, c):
    """f64: the same formula order, within a few ulps; f32: within 1e-5."""
    h, q = cubic_case(seed=1, n=40)
    x = gaussian(2, 40)
    tol = 1e-13 if dtype == "float64" else 1e-5
    fj = JCubic(q_mat=jnp.asarray(h, dtype), q_vec=jnp.asarray(q, dtype), c=jnp.asarray(c, dtype))
    ft = apt.cubic_from_numpy(h, q, c, device="cpu", dtype=getattr(torch, dtype))
    assert dict(ft.named_buffers()).keys() == {"q_mat", "q_vec", "c"}
    vj, gj = fj.value_and_grad(jnp.asarray(x, dtype))
    vt, auxt = ft.value_and_aux(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_allclose(float(vt), float(vj), rtol=tol)
    gjn = np_of(gj)
    np.testing.assert_allclose(np_of(auxt), gjn, rtol=0, atol=tol * np.abs(gjn).max())
    assert ft.grad_from_aux(None, auxt) is auxt  # aux is the gradient
    assert float(ft(torch.from_numpy(x).to(getattr(torch, dtype)))) == float(vt)


@pytest.mark.parametrize("k,n", [(100, 100), (7, 12), (1, 3)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_worst_quadratic_matches_jax(dtype, k, n):
    x = gaussian(4, n)
    tol = 1e-13 if dtype == "float64" else 1e-5
    fj = JWorstQuadratic(k=k, lip=jnp.asarray(100.0, dtype))
    ft = apt.worst_from_numpy(k, 100.0, n, device="cpu", dtype=getattr(torch, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    vj, gj = fj.value_and_grad(jnp.asarray(x, dtype))
    vt, aux = ft.value_and_aux(xt)
    assert aux is None
    gt = ft.grad_from_aux(xt, aux)
    np.testing.assert_allclose(float(vt), float(vj), rtol=tol)
    np.testing.assert_allclose(np_of(gt), np_of(gj), rtol=0, atol=tol * np.abs(np_of(gj)).max())
    assert not np_of(gt)[k:].any()
    # the stencil is the dense (L/4) T of the driver's resident model
    h, q = worst_dense(k, n, 100.0)
    np.testing.assert_allclose(np_of(gt), h @ x + q, rtol=0, atol=tol * np.abs(h @ x).max())


def test_worst_from_numpy_refuses_k_past_n():
    with pytest.raises(ValueError, match="1 <= k <= n"):
        apt.worst_from_numpy(5, 1.0, 4, device="cpu", dtype=F64)


# -- the engine on both objectives ------------------------------------------------------

# (gamma0, the JAX side, the port's side) of each objective; cubic c = 1
ENGINE_GAMMA = {"cubic": 0.01, "worst": 1 / 100}


def _objective(side, kind, n=128):
    if kind == "cubic":
        h, q = cubic_case()
        if side == "jax":
            return JCubic(q_mat=jnp.asarray(h), q_vec=jnp.asarray(q), c=jnp.asarray(1.0)), n
        return apt.cubic_from_numpy(h, q, 1.0, device="cpu", dtype=F64), n
    if side == "jax":
        return JWorstQuadratic(k=50, lip=jnp.asarray(100.0)), 60
    return apt.worst_from_numpy(50, 100.0, 60, device="cpu", dtype=F64), 60


def _engine(side, kind, rule, tol, maxit, history=True):
    f, n = _objective(side, kind)
    mod = ap if side == "jax" else apt
    g = mod.Zero()
    x0 = jnp.zeros(n) if side == "jax" else torch.zeros(n, dtype=F64)
    gam = ENGINE_GAMMA[kind]
    kw = dict(f=f, g=g, tol=tol, maxit=maxit, history=history)
    if rule == "fixed":
        return mod.fixed_proxgrad(x0, gamma=gam, **kw), f, g
    if rule == "nesterov":
        return mod.fixed_nesterov(x0, gamma=gam, **kw), f, g
    cls = mod.MalitskyMishchenkoRule if rule == "mm" else mod.AdaPGMRule
    return mod.adaptive_proxgrad(x0, rule=cls(gamma=gam), **kw), f, g


@pytest.mark.parametrize("kind", ["cubic", "worst"])
@pytest.mark.parametrize("rule,horizon", [("fixed", 200), ("nesterov", 200), ("mm", 25),
                                          ("adapgm", 15)])
def test_engine_rows_match_jax(kind, rule, horizon):
    """aux=None (WorstQuadratic) and aux=grad (Cubic) both go straight to
    grad_from_aux in the engine and in fixed_nesterov."""
    rj, _, _ = _engine("jax", kind, rule, 0.0, horizon)
    rt, _, _ = _engine("torch", kind, rule, 0.0, horizon)
    assert rt.numit == int(rj.numit) == horizon
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    for k in HIST:
        np.testing.assert_allclose(np_of(getattr(rt.records, k)), np_of(getattr(rj.records, k)),
                                   rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=0,
                               atol=1e-9 * np.abs(np_of(rj.x)).max())


@pytest.mark.parametrize("kind,rule", [("cubic", "adapgm"), ("cubic", "mm"), ("worst", "adapgm")])
def test_engine_converges_to_jax_solution(kind, rule):
    tol = 1e-9
    rj, fj, gj = _engine("jax", kind, rule, tol, 20000, history=False)
    rt, ft, gt = _engine("torch", kind, rule, tol, 20000, history=False)
    for r in (rj, rt):
        assert int(r.numit) < 20000 and float(r.norm_res) <= tol
    assert abs(rt.numit - int(rj.numit)) <= max(25, int(rj.numit) // 10)
    xj, xt = np_of(rj.x), np_of(rt.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-7 * np.abs(xj).max())
    np.testing.assert_allclose(float(ft.value(rt.x)), float(fj.value(rj.x)), rtol=1e-12)


# -- K2 and K2c with the cubic objective ----------------------------------------------

# the first relative difference past 1e-11 (module docstring), by rule and c
K2_HORIZON = {("adapgm", 1.0): 15, ("mm", 1.0): 25, ("adapgm", 0.0): 50, ("mm", 0.0): 60,
              ("fixed", 1.0): 60, ("fixed", 0.0): 60}


def _k2_both(c, tol, maxit, **kw):
    h, q = cubic_case()
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c, **kw)
    oj = jr.resident_adapgm(jnp.asarray(h), jnp.asarray(q), jnp.zeros(128), 0.01, tol, maxit,
                            interpret=True, **kw)
    ot = tr.resident_adapgm(torch.from_numpy(h), torch.from_numpy(q), torch.zeros(128, dtype=F64),
                            0.01, tol, maxit, **kw)
    return [np_of(v) for v in oj], [np_of(v) for v in ot]


@pytest.mark.parametrize("c", [0.0, 1.0])
@pytest.mark.parametrize("rule,momentum", [("adapgm", False), ("mm", False), ("fixed", False),
                                           ("fixed", True)])
def test_k2_cubic_matches_jax(rule, momentum, c):
    kw = dict(rule_kind=rule, momentum=momentum)
    horizon = K2_HORIZON[rule, c]
    launches = tr.resident_adapgm.launches
    oj, ot = _k2_both(c, 0.0, horizon, record=True, **kw)
    assert tr.resident_adapgm.launches == launches  # CPU tensors: the plain version
    assert int(ot[1]) == int(oj[1]) == horizon and not ot[3] and not oj[3]
    for k, name in enumerate(HIST, start=4):
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-9, err_msg=name)
    assert float(ot[2]) == pytest.approx(float(oj[2]), rel=1e-6)  # f32 stats on both sides
    np.testing.assert_allclose(ot[0], oj[0], rtol=0, atol=1e-9 * np.abs(oj[0]).max())
    # without records: the same solve
    _, plain = _k2_both(c, 0.0, horizon, **kw)
    for u, w in zip(plain, ot[:4]):
        np.testing.assert_array_equal(u, w)


def test_k2_cubic_objective_is_the_model():
    """The recorded f is 0.5 x'Hx + q'x + (c/6)||x||^3 at the recorded
    iterate, and the engine's Cubic gives the same rows."""
    h, q = cubic_case(seed=2)
    out = tr.resident_adapgm(torch.from_numpy(h), torch.from_numpy(q),
                             torch.zeros(128, dtype=F64), 0.01, 0.0, 1, prox_kind="zero",
                             obj_kind="cubic", cube_c=2.0, rule_kind="fixed", record=True)
    x1 = -0.01 * q  # the warm-up step from 0: grad(0) = q
    want = 0.5 * x1 @ h @ x1 + q @ x1 + 2.0 / 6 * np.linalg.norm(x1) ** 3
    assert float(out[6][0]) == pytest.approx(want, rel=1e-13)
    f = apt.cubic_from_numpy(h, q, 2.0, device="cpu", dtype=F64)
    res = apt.fixed_proxgrad(torch.zeros(128, dtype=F64), f=f, g=apt.Zero(), gamma=0.01, tol=0.0,
                             maxit=1, history=True)
    assert float(res.records.objective[0]) == pytest.approx(want, rel=1e-13)


def test_k2_cubic_converges_like_jax_and_keeps_padding_zero():
    """The model on the first 100 coordinates of 128, zero-padded as the
    drivers pad it: the padded coordinates stay exactly 0."""
    h, q = cubic_case(seed=3, n=100)
    hp, qp = np.zeros((128, 128)), np.zeros(128)
    hp[:100, :100], qp[:100] = h, q
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)
    oj = jr.resident_adapgm(jnp.asarray(hp), jnp.asarray(qp), jnp.zeros(128), 0.01, 1e-9, 3000,
                            interpret=True, **kw)
    ot = tr.resident_adapgm(torch.from_numpy(hp), torch.from_numpy(qp),
                            torch.zeros(128, dtype=F64), 0.01, 1e-9, 3000, **kw)
    assert bool(ot[3]) and bool(oj[3])
    numit = int(oj[1])
    assert numit < 3000 and abs(int(ot[1]) - numit) <= max(25, numit // 10)
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=0,
                               atol=1e-7 * np.abs(np_of(oj[0])).max())
    assert not np_of(ot[0])[100:].any()


def _cubic_driver_model():
    x, y, _ = load_or_synthesize("heart_scale", labels=(0.0, 1.0))
    h, q = tcubic.logistic_loss_grad_hessian(x, y, np.zeros(x.shape[1] + 1))
    hp, qp = tcubic.padded_model(h, q, "cpu", F64)
    f = apt.cubic_from_numpy(h, q, 1.0, device="cpu", dtype=F64)
    gam = tcubic.secant_gamma(f, np.zeros(q.shape[0]), 0, "cpu", F64)
    return np_of(hp), np_of(qp), gam


@pytest.mark.parametrize("driver", ["cubic", "worst"])
def test_k2c_cubic_matches_jax_sweep(driver, no_download):
    """The drivers' rows through JAX's sweep and the port's: the cubic
    driver's three rows (the ground truth at tol/10 with cap maxit x 10) on
    heart_scale's model, c = 1, and the worst case's four (momentum row
    included) at k = n = 100, c = 0, 300 iterations."""
    if driver == "cubic":
        h, q, gam = _cubic_driver_model()
        specs, c, tol, maxit = tcubic.rule_specs(gam, 1e-7, 100), 1.0, 1e-7, 1000
        horizon = {"adapgm": 100, "mm": 100, "fixed": 100}
    else:
        h, q = tworst.worst_case_model(100, 100, 100.0, "cpu", F64)
        h, q = np_of(h), np_of(q)
        specs = [(0.01, rule, mom, 1e-6, 300) for _, rule, mom in tworst.RESIDENT_ROWS]
        c, tol, maxit = 0.0, 1e-6, 300
        horizon = {"adapgm": 300, "mm": 45, "fixed": 300}
    rows = jr.rule_rows(specs)
    np.testing.assert_array_equal(tr.rule_rows(specs), rows)
    kw = dict(prox_kind="zero", obj_kind="cubic", cube_c=c)
    xj, itj, _, cj, hj = jr.resident_rule_sweep(jnp.asarray(h), jnp.asarray(q), jnp.zeros(128),
                                                rows, tol, maxit, interpret=True, **kw)
    launches = tr.resident_rule_sweep.launches
    xt, itt, _, ct, ht = tr.resident_rule_sweep(torch.from_numpy(h), torch.from_numpy(q),
                                                torch.zeros(128, dtype=F64), rows, tol, maxit, **kw)
    assert tr.resident_rule_sweep.launches == launches  # CPU tensors: the plain version
    for j, (g0, rule, mom, t, cap) in enumerate(specs):
        numit = int(itj[j])
        assert int(itt[j]) == numit and bool(ct[j]) == bool(cj[j]), j
        hz = min(horizon[rule], numit)
        for k in range(3):
            np.testing.assert_allclose(np_of(ht[k][j])[:hz], np_of(hj[k][j])[:hz], rtol=1e-9,
                                       err_msg=f"row {j} {HIST[k]}")
            assert not np_of(ht[k][j])[cap:].any()
        assert not np_of(xt[j])[100 if driver == "worst" else 14:].any()  # padding stays 0
        # each row of the sweep is its single plain solve, bit for bit
        one = tr.resident_adapgm(torch.from_numpy(h), torch.from_numpy(q),
                                 torch.zeros(128, dtype=F64), g0, t, cap, rule_kind=rule,
                                 momentum=mom, record=True, **kw)
        assert torch.equal(xt[j], one[0]) and int(itt[j]) == int(one[1])
        assert all(torch.equal(ht[k][j][:cap], one[4 + k]) for k in range(3))


@pytest.mark.parametrize("entry", ["single", "sweep"])
@pytest.mark.parametrize("shape", [(64, 128), (128, 64)])
def test_cubic_refuses_a_non_square_h(entry, shape):
    a = torch.zeros(shape, dtype=F64)
    b, x0 = torch.zeros(shape[0], dtype=F64), torch.zeros(shape[1], dtype=F64)
    with pytest.raises(ValueError, match="square H"):
        if entry == "single":
            tr.resident_adapgm(a, b, x0, 0.1, 0.0, 5, obj_kind="cubic", cube_c=1.0)
        else:
            tr.resident_rule_sweep(a, b, x0, tr.rule_rows([(0.1, "fixed", False)], 0.0, 5), 0.0,
                                   5, obj_kind="cubic", cube_c=1.0)


# -- the drivers ----------------------------------------------------------------------

# the rows as the drivers write them: the ground truth, the backtracking rows, the
# rule rows; the worst case interleaves each backtracking row after its fixed one
CUBIC_RULE_NAMES = [name for name, _ in tcubic.RESIDENT_ROWS]
CUBIC_BT_NAMES = [name for name, _, _ in tcubic.BT_ROWS]
CUBIC_NAMES = CUBIC_RULE_NAMES[:1] + CUBIC_BT_NAMES + CUBIC_RULE_NAMES[1:]
WORST_RULE_NAMES = [name for name, _, _ in tworst.RESIDENT_ROWS]
WORST_BT_NAMES = [name for name, _, _ in tworst.BT_ROWS]
WORST_NAMES = [WORST_RULE_NAMES[0], WORST_BT_NAMES[0], WORST_RULE_NAMES[1], WORST_BT_NAMES[1],
               *WORST_RULE_NAMES[2:]]
# heart_scale's aGRAAL row (85 iterations to tol) first differs past 1e-9 at iteration 68
# on the engine path and 84 under --resident (f64 on the CPU): held over 45
CUBIC_AGRAAL_HORIZON = {"aGRAAL": 45}
# the worst case's MM row first differs past 1e-9 at iteration 59 (module docstring)
WORST_HORIZON = {"AdaPGM (MM)": 45}


def _by_method(rows):
    by = {}
    for r in rows:
        if "it" in r:
            by.setdefault(r.get("method"), []).append(r)
    return by


def _rows_match(trows, jrows, names, horizon):
    jby, tby = _by_method(jrows), _by_method(trows)
    assert list(tby) == names
    for name, rows in tby.items():
        want = jby[name]
        assert len(rows) == len(want), name
        for rt, rj in list(zip(rows, want))[:horizon.get(name, len(want))]:
            assert [k for k in rt if k != "method"] == [k for k in rj if k != "method"]
            for k, v in rj.items():
                if isinstance(v, float):
                    assert rt[k] == pytest.approx(v, rel=1e-9), (name, k)
                else:
                    assert rt[k] == v, (name, k)


def _meta_match(trows, jrows, path, names, tail, bt_names):
    tmeta = [r for r in trows if "it" not in r]
    jmeta = [r for r in jrows if "it" not in r]
    if path == "resident":
        assert list(tmeta[0]) == ["grid_total_s"]
        assert list(tmeta[0]["grid_total_s"]) == list(jmeta[0]["grid_total_s"]) == [
            "bt sweep", "rule sweep"]
        tmeta, jmeta = tmeta[1:], jmeta[1:]
        # each sweep's rows share its wall, the backtracking rows first (as in JAX)
        names = bt_names + [name for name in names if name not in bt_names]
    assert [list(r) for r in tmeta] == [list(r) for r in jmeta] == [
        ["wall_s", "fast_path", "fast_methods"]] + tail
    assert list(tmeta[0]["wall_s"]) == names
    assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == path
    assert tmeta[0]["fast_methods"] == (sorted(names) if path == "resident" else [])
    return tmeta, jmeta


@pytest.mark.parametrize("path", ["default", "resident"])
def test_cubic_driver_jsonl_matches_jax(tmp_path, capsys, no_download, path):
    """heart_scale (its synthetic stand-in, 270x13: H is 14x14, padded to
    128 under --resident), the defaults (maxit 100, tol 1e-7, lam 1), f64,
    against the JAX driver's JSONL, every row, aGRAAL's included."""
    args = ["--datasets", "heart_scale", "--no-plot"] + (["--resident"] if path == "resident"
                                                         else [])
    jcubic.main(["--outdir", str(tmp_path / "jax"), "--cpu", *args])
    capsys.readouterr()
    tcubic.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    assert "skipping rows not ported yet" not in capsys.readouterr().out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "heart_scale.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "heart_scale.jsonl")
    assert trows[0]["method"] is None and list(trows[0])[0] == "method"
    _rows_match(trows, jrows, CUBIC_NAMES + ["aGRAAL"], CUBIC_AGRAAL_HORIZON)
    tmeta, jmeta = _meta_match(trows, jrows, path,
                               ["(ground truth)"] + CUBIC_NAMES[1:] + ["aGRAAL"],
                               [["data_source"]], CUBIC_BT_NAMES)
    assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"])
    assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}


@pytest.mark.parametrize("path", ["default", "resident"])
def test_worst_case_driver_jsonl_matches_jax(tmp_path, capsys, path):
    """k = n = 100, L = 100, tol 1e-6, maxit cut from 10000 to 300, f64:
    the known-optimum row, then every row of the JAX driver, in its order
    (the backtracking rows agreed to the end, trial counts and all)."""
    args = ["--maxit", "300", "--no-plot"] + (["--resident"] if path == "resident" else [])
    jworst.main(["--outdir", str(tmp_path / "jax"), "--cpu", *args])
    capsys.readouterr()
    tworst.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    out = capsys.readouterr().out
    assert "skipping rows not ported yet" not in out and "optimum=-12.37623762" in out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "nesterov_worst_case.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "nesterov_worst_case.jsonl")
    assert trows[0] == {"method": None, "it": 1, "objective": (100 / 8) * (1 / 101 - 1)}
    assert trows[0]["objective"] == jrows[0]["objective"]
    _rows_match(trows[1:], jrows[1:], WORST_NAMES, WORST_HORIZON)
    _meta_match(trows, jrows, path, WORST_NAMES, [], WORST_BT_NAMES)


@pytest.mark.parametrize("driver", ["cubic", "worst"])
def test_driver_resident_is_one_sweep(tmp_path, monkeypatch, driver):
    """``--resident`` runs the rule rows as one rule-sweep call, with the
    cubic objective, the driver's c and its per-row tol and caps, and the
    backtracking rows as one backtracking-sweep call."""
    mod = tcubic if driver == "cubic" else tworst
    calls, bt_calls = [], []
    sweep, bt_sweep = mod.resident_rule_sweep, mod.resident_bt_sweep

    def counting(*args, **kw):
        calls.append((args[3], args[5], kw))
        return sweep(*args, **kw)

    def bt_counting(*args, **kw):
        bt_calls.append((args[3], args[5], kw))
        return bt_sweep(*args, **kw)

    monkeypatch.setattr(mod, "resident_rule_sweep", counting)
    monkeypatch.setattr(mod, "resident_bt_sweep", bt_counting)
    args = ["--outdir", str(tmp_path), "--resident", "--maxit", "40", "--no-plot", "--device",
            "cpu"]
    mod.main(args + (["--datasets", "heart_scale"] if driver == "cubic" else []))
    assert len(calls) == 1 and len(bt_calls) == 1
    bt_rows, bt_maxit, bt_kw = bt_calls[0]
    assert bt_maxit == 40 and bt_kw["obj_kind"] == "cubic" and bt_kw["prox_kind"] == "zero"
    if driver == "cubic":
        assert bt_kw["cube_c"] == 1.0 and bt_rows[0, 0] == calls[0][0][0, 0]
        np.testing.assert_array_equal(bt_rows[:, 1:], [[1.0, 0], [1.5, 0], [2.0, 0], [1.0, 1]])
    else:
        assert bt_kw["cube_c"] == 0.0
        np.testing.assert_array_equal(bt_rows, [[1.0, 1.0, 0], [1.0, 1.0, 1]])
    rows, maxit, kw = calls[0]
    assert kw["obj_kind"] == "cubic" and kw["prox_kind"] == "zero"
    if driver == "cubic":
        assert maxit == 400 and kw["cube_c"] == 1.0
        np.testing.assert_array_equal(rows[:, 1:], [[2, 0, 1e-8, 400], [1, 0, 1e-7, 40],
                                                    [2, 0, 1e-7, 40]])
    else:
        assert maxit == 40 and kw["cube_c"] == 0.0
        np.testing.assert_array_equal(rows, [[0.01, 0, 0, 1e-6, 40], [0.01, 0, 1, 1e-6, 40],
                                             [0.01, 1, 0, 1e-6, 40], [0.01, 2, 0, 1e-6, 40]])


@pytest.mark.parametrize("driver", ["cubic", "worst"])
def test_drivers_refuse_a_missing_card(tmp_path, driver):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = tcubic if driver == "cubic" else tworst
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--outdir", str(tmp_path), "--no-plot"])
