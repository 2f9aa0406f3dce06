"""The whole-solve kernel K2 of the PyTorch port against the JAX package, on
the same numpy inputs (f64 on the CPU).

The JAX side runs its Pallas kernel ``resident_adapgm`` in interpret mode, as
tests/test_kernels.py does; the port's ``resident_adapgm`` takes its plain
version on CPU tensors. The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py.

About the horizons. The two sides sum in different orders, so they differ by
~1e-16 after the first matvec; the adaptive rules amplify that (see
tests/test_torch_engine.py). On ``random_lasso(64, 128, 8, seed=3)`` the
history rows first drift past 1e-11 at iteration 32 (AdaPGM, l1), 36 (MM),
14 (AdaPGM, box), 55 (AdaPGM, elastic) and 38 (AdaPGM, zero), and never in
120 iterations of the fixed rule (measured). Each case is held to rtol 1e-9
over a horizon below those, 100x inside the drift. The final x drifts sooner
where it has a direction the objective does not see (the zero prox on this
m < n problem: 5e-9 of max|x| at 30 iterations, 2e-12 at 20), so x is
compared after at most 20 iterations (drift at most 3e-12 of max|x|, measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lasso_case, np_of

import adaprox_tpu.utils.logging as jlog
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import lasso as tlasso
from adaprox_tpu_torch.ops import resident as tr
from adaprox_tpu_torch.models.synthetic import random_lasso

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective")


def _case():
    prob = random_lasso(m=64, n=128, pfactor=8, seed=3)
    return prob.a, prob.b, 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)


def _both(a, b, gamma0, tol, maxit, **kw):
    """The same solve through JAX's kernel (interpret mode) and the port."""
    oj = jr.resident_adapgm(jnp.asarray(a), jnp.asarray(b), jnp.zeros(a.shape[1]), gamma0, tol,
                            maxit, interpret=True, **kw)
    ot = tr.resident_adapgm(torch.from_numpy(a), torch.from_numpy(b),
                            torch.zeros(a.shape[1], dtype=F64), gamma0, tol, maxit, **kw)
    return [np_of(v) for v in oj], [np_of(v) for v in ot]


# -- routing ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [
    ((64, 128), "float32"), ((100, 300), "float32"), ((64, 130), "float32"),
    ((60, 128), "float32"), ((104, 384), "float64"),
    ((3072, 2048), "float32"), ((3080, 2048), "float32"),       # the 24 MB edge, f32
    ((6144, 2048), "bfloat16"), ((6152, 2048), "bfloat16"),     # ... bf16 storage
    ((1536, 2048), "float64"), ((1544, 2048), "float64"),       # ... f64
    ((8, 786432), "float32"), ((32768, 128), "float32"), ((4096, 1024), "float32"),
])
def test_resident_supported_matches_jax(shape, dtype):
    want = jr.resident_supported(jax.ShapeDtypeStruct(shape, getattr(jnp, dtype)))
    got = tr.resident_supported(torch.empty(shape, dtype=getattr(torch, dtype), device="meta"))
    assert got == want


# -- the kernel's solve -------------------------------------------------------------


@pytest.mark.parametrize("rule,prox,p1,p2,horizon", [
    ("adapgm", "l1", 1.0, 0.0, 30),
    ("mm", "l1", 1.0, 0.0, 30),
    ("fixed", "l1", 1.0, 0.0, 120),
    ("adapgm", "box", -0.1, 0.1, 12),
    ("adapgm", "elastic", 1.0, 0.5, 50),
    ("adapgm", "zero", 0.0, 0.0, 35),
])
def test_resident_rows_match_jax(rule, prox, p1, p2, horizon):
    a, b, gamma0 = _case()
    kw = dict(prox_kind=prox, p1=p1, p2=p2, rule_kind=rule)
    launches = tr.resident_adapgm.launches
    oj, ot = _both(a, b, gamma0, 0.0, 120, record=True, **kw)
    assert tr.resident_adapgm.launches == launches  # CPU tensors: the plain version
    assert int(ot[1]) == int(oj[1]) == 120 and not ot[3] and not oj[3]
    for k, name in enumerate(HIST, start=4):
        assert ot[k].shape == (120,)
        np.testing.assert_allclose(ot[k][:horizon], oj[k][:horizon], rtol=1e-9, err_msg=name)
    # x and norm_res of a solve that stops inside the horizon
    short = min(horizon, 20)
    oj, ot = _both(a, b, gamma0, 0.0, short, **kw)
    assert int(ot[1]) == int(oj[1]) == short and bool(ot[3]) == bool(oj[3])
    # norm_res travels through the kernel's f32 stats on both sides
    assert ot[2].dtype == np.float64 and float(ot[2]) == pytest.approx(float(oj[2]), rel=1e-6)
    # small components carry the drift of the large ones: atol scales with max|x|
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-9, atol=1e-9 * np.abs(oj[0]).max())


@pytest.mark.parametrize("rule", ["adapgm", "mm"])
def test_resident_converges_to_jax_solution(rule):
    a, b, gamma0 = _case()
    oj, ot = _both(a, b, gamma0, 1e-6, 3000, prox_kind="l1", p1=1.0, rule_kind=rule)
    assert bool(ot[3]) and bool(oj[3])
    numit = int(oj[1])
    assert numit < 3000 and abs(int(ot[1]) - numit) <= max(25, numit // 10)
    assert float(ot[2]) <= 1e-6
    np.testing.assert_allclose(ot[0], oj[0], rtol=0, atol=1e-6)


def test_record_mode_does_not_change_the_solve():
    a, b, gamma0 = _case()
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.zeros(128, dtype=F64), gamma0,
            1e-6, 500)
    plain = tr.resident_adapgm(*args, p1=1.0)
    rec = tr.resident_adapgm(*args, p1=1.0, record=True)
    assert len(plain) == 4 and len(rec) == 7
    for u, w in zip(plain, rec[:4]):
        assert torch.equal(u, w)
    numit = int(rec[1])
    assert 0 < numit < 500 and bool(rec[3])
    for h in rec[4:]:  # zero past numit
        assert bool((h[numit:] == 0).all()) and bool((h[:numit] != 0).all())


def test_zero_iterations_match_jax():
    a, b, gamma0 = _case()
    oj, ot = _both(a, b, gamma0, 1e-6, 0, p1=1.0)
    assert int(ot[1]) == int(oj[1]) == 0 and float(ot[2]) == float(oj[2]) == np.inf
    assert not ot[3] and not oj[3]
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-12, atol=1e-15)


def test_lasso_alias_matches_jax():
    a, b, gamma0 = _case()
    oj = jr.resident_adapgm_l1(jnp.asarray(a), jnp.asarray(b), jnp.zeros(128), gamma0, 1.0,
                               0.0, 30, interpret=True)
    ot = apt.resident_adapgm_l1(torch.from_numpy(a), torch.from_numpy(b),
                                torch.zeros(128, dtype=F64), gamma0, 1.0, 0.0, 30)
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=1e-9, atol=1e-12)
    assert int(ot[1]) == int(oj[1]) == 30


def test_resident_records_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    maxit, numit = 50, 37
    hists = [np.where(np.arange(maxit) < numit, rng.standard_normal(maxit), 0.0)
             for _ in HIST]
    rj = jr.resident_records(jnp.int32(numit), *(jnp.asarray(h) for h in hists), maxit=maxit)
    rt = apt.resident_records(torch.tensor(numit, dtype=torch.int32),
                              *(torch.from_numpy(h) for h in hists), maxit=maxit)
    assert rt._fields == rj._fields
    for k in rt._fields:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), err_msg=k)
    # and the same JSONL through each package's writer
    nj, lj = jlog.write_records_jsonl(tmp_path / "j.jsonl", rj, "m")
    nt, lt = tlog.write_records_jsonl(tmp_path / "t.jsonl", rt.numpy(), "m")
    assert (nt, lt) == (nj, lj) and nt == numit
    assert tlog.read_jsonl(tmp_path / "t.jsonl") == jlog.read_jsonl(tmp_path / "j.jsonl")


# logreg and cubic are ported (tests/test_torch_logreg.py, tests/test_torch_cubic.py);
# cubic, with or without its c, refuses an H that is not square
@pytest.mark.parametrize("kw", [dict(obj_kind="cubic"), dict(obj_kind="cubic", cube_c=2.0)])
def test_resident_refuses_what_is_not_ported(kw):
    a, b, gamma0 = _case()
    with pytest.raises(ValueError, match="square H"):
        tr.resident_adapgm(torch.from_numpy(a), torch.from_numpy(b),
                           torch.zeros(128, dtype=F64), gamma0, 0.0, 5, **kw)


@pytest.mark.parametrize("kw,exc", [(dict(rule_kind="nope"), ValueError),
                                    (dict(prox_kind="nope"), ValueError)])
def test_resident_rejects_unknown_menu_entries(kw, exc):
    a, b, gamma0 = _case()
    with pytest.raises(exc, match="must be one of"):
        tr.resident_adapgm(torch.from_numpy(a), torch.from_numpy(b),
                           torch.zeros(128, dtype=F64), gamma0, 0.0, 5, **kw)


# -- the driver's rows --------------------------------------------------------------

MENU = ("PGM (fixed)", "PGM (backtracking)-(xi=1.0)", "PGM (backtracking)-(xi=1.5)",
        "PGM (backtracking)-(xi=2.0)", "Nesterov (backtracking)", "Nesterov (fixed)", "AdaPGM (MM)",
        "AdaPGM (Ours)", "aGRAAL")
# the engine horizons of tests/test_torch_engine.py; the momentum row does not
# amplify (tests/test_torch_sweep.py), so it is held over all 300 iterations, and
# the backtracking rows agreed with the engine's to the end (trial counts and all;
# tests/test_torch_backtracking.py); aGRAAL's plain kernel and engine compute with
# the same torch operations from the same companion point: equal over all 300
DRIVER_HORIZON = {"PGM (fixed)": 300, "Nesterov (fixed)": 300, "AdaPGM (MM)": 60,
                  "AdaPGM (Ours)": 20, **{name: 300 for name in MENU[1:5]}, "aGRAAL": 300}


def _rows_by_method(path):
    by = {}
    for r in tlog.read_jsonl(path):
        if r.get("method"):
            by.setdefault(r["method"], []).append(r)
    return by


def test_lasso_driver_resident_matches_engine(tmp_path, capsys):
    """``--resident`` (one backtracking sweep and one rule sweep) against the
    port's engine (``--fused``: the same padded A) on the same menu, row for
    row over the engine horizons."""
    args = ["--sizes", "100x300x10", "--maxit", "300", "--no-plot", "--device", "cpu"]
    tlasso.main(["--outdir", str(tmp_path / "res"), "--resident", *args])
    assert "falling back" not in capsys.readouterr().out
    tlasso.main(["--outdir", str(tmp_path / "eng"), "--fused", *args])
    res = _rows_by_method(tmp_path / "res" / "lasso_100_300_10.jsonl")
    eng = _rows_by_method(tmp_path / "eng" / "lasso_100_300_10.jsonl")
    assert list(res) == list(eng) == list(MENU)
    for name, horizon in DRIVER_HORIZON.items():
        assert len(res[name]) == len(eng[name])
        for rr, re in zip(res[name][:horizon], eng[name][:horizon]):
            assert list(rr) == list(re)
            for k, v in re.items():
                if isinstance(v, float):
                    assert rr[k] == pytest.approx(v, rel=1e-9), (name, k)
                else:
                    assert rr[k] == v, (name, k)
    rows = tlog.read_jsonl(tmp_path / "res" / "lasso_100_300_10.jsonl")
    meta = rows[-1]
    assert list(rows[-2]) == ["grid_total_s"]
    assert list(meta) == ["wall_s", "fast_path", "fast_methods"]
    assert meta["fast_path"] == "resident" and meta["fast_methods"] == sorted(MENU)
    assert sorted(meta["wall_s"]) == sorted(MENU)


def test_lasso_driver_resident_falls_back_like_jax(tmp_path, capsys):
    """f64 at 3000x1100 pads to 3000x1152: 27.6 MB, past the routing limit."""
    tlasso.main(["--outdir", str(tmp_path), "--resident", "--sizes", "3000x1100x10",
                 "--maxit", "2", "--no-plot", "--device", "cpu"])
    assert "falling back to the engine" in capsys.readouterr().out
    meta = tlog.read_jsonl(tmp_path / "lasso_3000_1100_10.jsonl")[-1]
    assert meta["fast_path"] == "default" and meta["fast_methods"] == []


def test_driver_rows_match_jax_rule_sweep():
    """The rows both drivers emit under ``--resident`` come from their rule
    sweeps (one launch for the menu). The driver's specs at 64x128 f64, the
    port's sweep against JAX's."""
    a, b, lam, _, gamma0 = lasso_case(64, 128, 8, 3)
    tol, maxit = 1e-7, 200
    rows = jr.rule_rows([(gamma0, rule, mom) for _, rule, mom in tlasso.RESIDENT_ROWS],
                        tol=tol, maxit=maxit)
    np.testing.assert_array_equal(tr.rule_rows(
        [(gamma0, rule, mom) for _, rule, mom in tlasso.RESIDENT_ROWS], tol=tol, maxit=maxit), rows)
    _, itj, _, _, hj = jr.resident_rule_sweep(
        jnp.asarray(a), jnp.asarray(b), jnp.zeros(128), rows, tol, maxit, prox_kind="l1", p1=lam,
        interpret=True)
    _, itt, _, _, ht = tr.resident_rule_sweep(
        torch.from_numpy(a), torch.from_numpy(b), torch.zeros(128, dtype=F64), rows, tol, maxit,
        prox_kind="l1", p1=lam)
    horizon = {"PGM (fixed)": maxit, "Nesterov (fixed)": maxit, "AdaPGM (MM)": 30,
               "AdaPGM (Ours)": 30}
    for j, (name, _, mom) in enumerate(tlasso.RESIDENT_ROWS):
        recs = tr.resident_records(itt[j], *(h[j] for h in ht), maxit=maxit, momentum=mom)
        h = horizon[name]
        for k, hist in enumerate(hj):
            np.testing.assert_allclose(np_of(ht[k][j])[:h], np_of(hist[j])[:h], rtol=1e-9,
                                       err_msg=f"{name} {HIST[k]}")
        numit = int(itj[j])
        # the adaptive rows stop where tol lands: within JAX's own band
        assert abs(int(itt[j]) - numit) <= max(25, numit // 10), name
        assert int(recs.valid.sum()) == int(itt[j])
