"""The port's lasso path as a whole: its numpy-only copies against the JAX
package's originals, its driver's JSONL against the JAX driver's, the port
running without JAX, and chip_smoke.py refusing to run without a card."""

import ast
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of

import adaprox_tpu.models.synthetic as jsyn
import adaprox_tpu.utils.logging as jlog
import adaprox_tpu_torch.models.synthetic as tsyn
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import common as jcommon
from adaprox_tpu.experiments import lasso as jlasso
from adaprox_tpu_torch.experiments import common as tcommon
from adaprox_tpu_torch.experiments import lasso as tlasso

REPO = Path(__file__).resolve().parent.parent
MENU = ("PGM (fixed)", "PGM (backtracking)-(xi=1.0)", "PGM (backtracking)-(xi=1.5)",
        "PGM (backtracking)-(xi=2.0)", "Nesterov (backtracking)", "Nesterov (fixed)", "AdaPGM (MM)",
        "AdaPGM (Ours)", "aGRAAL")


# -- (e) the numpy-only copies ----------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(m=100, n=300, pfactor=10, seed=0),
    dict(m=64, n=96, pfactor=8, seed=3),
    dict(m=50, n=40, pfactor=5, seed=1, lam=20.0),  # lam > 10: the min(lam, lam/|c'y|) fix
    dict(m=30, n=60, pfactor=6, seed=2, rho=0.5, dtype=np.float32),
])
def test_random_lasso_is_bit_identical(kw):
    pj, pt = jsyn.random_lasso(**kw), tsyn.random_lasso(**kw)
    for k in ("a", "b", "x_star"):
        vj, vt = getattr(pj, k), getattr(pt, k)
        assert vj.dtype == vt.dtype and vj.tobytes() == vt.tobytes()
    assert pj.lam == pt.lam and pj.optimum == pt.optimum


def test_logging_copy_matches_jax_writer(tmp_path):
    assert tlog.PG_KEYS == jlog.PG_KEYS and tlog.PD_KEYS == jlog.PD_KEYS
    assert all(tlog.is_logstep(i) == jlog.is_logstep(i) for i in range(0, 3000))
    rng = np.random.default_rng(0)
    n = 37
    cols = {k: rng.standard_normal(n) for k in ("gamma", "sigma", "norm_res", "objective")}
    cols.update({k: np.arange(n) + j for j, k in enumerate(
        ("it", "f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals",
         "At_evals"))})
    cols["valid"] = np.arange(n) < 30
    from adaprox_tpu.solvers.common import Records as JRecords

    recs = JRecords(**{k: cols[k] for k in JRecords._fields})
    for keys in (None, ["method", "it", "norm_res"], ["it", "method", "objective"]):
        for pd in (None, True):
            nj, lj = jlog.write_records_jsonl(tmp_path / "j.jsonl", recs, "m", primal_dual=pd,
                                              keys=keys)
            nt, lt = tlog.write_records_jsonl(tmp_path / "t.jsonl", recs, "m", primal_dual=pd,
                                              keys=keys)
            assert (nt, lt) == (nj, lj)
    assert tlog.read_jsonl(tmp_path / "t.jsonl") == jlog.read_jsonl(tmp_path / "j.jsonl")
    assert tlog.records_to_rows(recs, "m") == jlog.records_to_rows(recs, "m")


@pytest.mark.parametrize("m,n", [(100, 300), (64, 128), (5, 7)])
def test_pad_tiles_matches_jax(m, n):
    a, b = np.random.default_rng(m).standard_normal((m, n)), np.arange(m, dtype=float)
    aj, bj = jcommon.pad_tiles(jnp.asarray(a), jnp.asarray(b))
    at, bt = tcommon.pad_tiles(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(np_of(at), np_of(aj))
    np.testing.assert_array_equal(np_of(bt), np_of(bj))


# -- (f) the driver's JSONL ---------------------------------------------------


def test_lasso_driver_jsonl_matches_jax(tmp_path, capsys):
    """The whole menu, --device cpu (f64), against the JAX driver's JSONL row
    for row, aGRAAL included (its companion point from the numpy copy of
    JAX's draw). 20 iterations: inside the horizon where the adaptive rules'
    step sizes agree to 1e-9 (see test_torch_engine.py and
    test_torch_agraal.py); measured 9e-14. The backtracking rows agree with
    JAX's, trial counts and all, to the end."""
    args = ["--sizes", "64x96x8", "--maxit", "20", "--no-plot", "--fused"]
    jlasso.main(["--outdir", str(tmp_path / "jax"), *args])
    tlasso.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    assert "skipping rows not ported yet" not in capsys.readouterr().out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "lasso_64_96_8.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "lasso_64_96_8.jsonl")
    assert trows[0] == jrows[0]  # the analytic-optimum pseudo record
    jm = [r for r in jrows if r.get("method") in MENU]
    tm = [r for r in trows if r.get("method") is not None]
    assert len(tm) == len(jm) == len(MENU) * 20
    for rj, rt in zip(jm, tm):
        assert list(rt) == list(rj)  # identical keys in identical order
        for k, v in rj.items():
            if isinstance(v, float):
                assert rt[k] == pytest.approx(v, rel=1e-9), k
            else:
                assert rt[k] == v, k
    jmeta, tmeta = jrows[-1], trows[-1]
    assert list(tmeta) == list(jmeta) == ["wall_s", "fast_path", "fast_methods"]
    assert tmeta["fast_path"] == jmeta["fast_path"] == "fused"
    assert list(tmeta["wall_s"]) == list(jmeta["wall_s"]) == list(MENU)
    assert sorted(MENU) == tmeta["fast_methods"]


def test_lasso_driver_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlasso.main(["--outdir", str(tmp_path), "--sizes", "8x16x2", "--no-plot"])


# -- (g) the port runs without JAX ------------------------------------------


_SLICE = r"""
import json, sys
# jax and the JAX package cannot be imported here: the port must not need them
for name in ("jax", "jaxlib", "adaprox_tpu"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import adaprox_tpu_torch as apt
from adaprox_tpu_torch.experiments.common import pad_tiles
from adaprox_tpu_torch.models.synthetic import random_lasso
prob = random_lasso(m=100, n=300, pfactor=10)
a, b = pad_tiles(torch.from_numpy(prob.a), torch.from_numpy(prob.b))
gam = 1.0 / float(torch.linalg.matrix_norm(torch.from_numpy(prob.a), 2) ** 2)
out = []
for fused in (False, True):
    f, g = apt.LeastSquares(a, b, fused=fused), apt.L1Norm(prob.lam)
    for rule in (apt.FixedStepsize(gamma=gam), apt.MalitskyMishchenkoRule(gamma=gam),
                 apt.AdaPGMRule(gamma=gam)):
        for history in (True, False):
            r = apt.adaptive_proxgrad(torch.zeros(a.shape[1], dtype=torch.float64), f=f,
                                      g=g, rule=rule, tol=1e-8, maxit=3000, history=history)
            out.append([r.numit, list(r.counters), float(f.value(r.x) + g(r.x))])
# the sparse-logreg slice: LogisticLoss both ways, K2's logistic objective, the driver
from adaprox_tpu_torch.experiments import sparse_logreg
from adaprox_tpu_torch.utils.datasets import load_or_synthesize
x, y, src = load_or_synthesize("heart_scale", labels=(0.0, 1.0))
gam = 1.0 / sparse_logreg.lipschitz_estimate(x)
logreg = []
for fused in (False, True):
    f, g = apt.logreg_from_numpy(x, y, 0.01, device="cpu", dtype=torch.float64, fused=fused)
    r = apt.adaptive_proxgrad(torch.zeros(14, dtype=torch.float64), f=f, g=g,
                              rule=apt.AdaPGMRule(gamma=gam), tol=1e-8, maxit=2000)
    logreg.append([r.numit, float(f.value(r.x) + g(r.x))])
x1, y1 = torch.zeros(272, 128, dtype=torch.float64), torch.zeros(272, dtype=torch.float64)
x1[:270, :13], x1[:270, 13], y1[:270] = torch.from_numpy(x), 1.0, torch.from_numpy(y)
k2 = apt.resident_logreg_l1(x1, y1, torch.zeros(128, dtype=torch.float64), gam, 0.01, 1e-8,
                            2000, m_true=270.0)
logreg.append([int(k2[1]), float(f.value(k2[0][:14]) + g(k2[0][:14]))])
sparse_logreg.main(["--device", "cpu", "--datasets", "heart_scale", "--maxit", "40",
                    "--no-plot", "--resident", "--outdir", sys.argv[1]])
# the cubic slice: Cubic in the engine and through K2's cubic objective, WorstQuadratic,
# and both drivers
import numpy as np
from adaprox_tpu_torch.experiments import cubic_sparse_logreg, nesterov_worst_case
h, q = cubic_sparse_logreg.logistic_loss_grad_hessian(x, y, np.zeros(14))
fc = apt.cubic_from_numpy(h, q, 1.0, device="cpu", dtype=torch.float64)
gam = cubic_sparse_logreg.secant_gamma(fc, np.zeros(14), 0, "cpu", torch.float64)
rc = apt.adaptive_proxgrad(torch.zeros(14, dtype=torch.float64), f=fc, g=apt.Zero(),
                           rule=apt.AdaPGMRule(gamma=gam), tol=1e-9, maxit=2000)
hp, qp = cubic_sparse_logreg.padded_model(h, q, "cpu", torch.float64)
kc = apt.resident_adapgm(hp, qp, torch.zeros(128, dtype=torch.float64), gam, 1e-9, 2000,
                         prox_kind="zero", obj_kind="cubic", cube_c=1.0)
fw = apt.worst_from_numpy(10, 100.0, 12, device="cpu", dtype=torch.float64)
rw = apt.adaptive_proxgrad(torch.zeros(12, dtype=torch.float64), f=fw, g=apt.Zero(),
                           rule=apt.AdaPGMRule(gamma=0.01), tol=1e-9, maxit=5000)
cubic = [[rc.numit, float(fc.value(rc.x))], [int(kc[1]), float(fc.value(kc[0][:14]))],
         [rw.numit, float(fw.value(rw.x))]]
cubic_sparse_logreg.main(["--device", "cpu", "--datasets", "heart_scale", "--maxit", "40",
                          "--no-plot", "--resident", "--outdir", sys.argv[1]])
nesterov_worst_case.main(["--device", "cpu", "--maxit", "50", "--no-plot", "--outdir",
                          sys.argv[1]])
# the backtracking slice: the engine solvers, K4 and K4b (plain versions), the lasso
# driver's backtracking rows on both paths
from adaprox_tpu_torch.experiments import lasso
prob = random_lasso(m=100, n=300, pfactor=10)
gam = 10.0 / float(torch.linalg.matrix_norm(torch.from_numpy(prob.a), 2) ** 2)
x0 = torch.zeros(a.shape[1], dtype=torch.float64)
f, g = apt.LeastSquares(a, b), apt.L1Norm(prob.lam)
bt = []
for solver, kw in ((apt.backtracking_proxgrad, {"xi": 1.5}), (apt.backtracking_nesterov, {})):
    r = solver(x0, f=f, g=g, gamma0=gam, tol=1e-8, maxit=1000, **kw)
    bt.append([r.numit, float(f.value(r.x) + g(r.x))])
for nesterov in (False, True):
    k4 = apt.resident_backtracking(a, b, x0, gam, 1e-8, 1000, xi=1.5, nesterov=nesterov,
                                   p1=prob.lam)
    bt.append([int(k4[1]), float(f.value(k4[0]) + g(k4[0]))])
sw = apt.resident_bt_sweep(a, b, x0, [[gam, 1.5, 0], [gam, 1.0, 1]], 1e-8, 1000, p1=prob.lam)
bt += [[int(sw[1][j]), float(f.value(sw[0][j]) + g(sw[0][j]))] for j in range(2)]
for path in ("--fused", "--resident"):
    lasso.main(["--device", "cpu", path, "--sizes", "64x128x8", "--maxit", "50", "--no-plot",
                "--outdir", sys.argv[1] + path])
# the aGRAAL slice: the engine solver and K4's aGRAAL core (plain version) from the
# companion point the drivers draw (the numpy copy of JAX's draw), and the engine
# drawing its own companion point
from adaprox_tpu_torch.experiments.common import companion_point
gam = 1.0 / float(torch.linalg.matrix_norm(torch.from_numpy(prob.a), 2) ** 2)
xc = companion_point(x0, 300)
ra = apt.agraal(x0, x0=xc, f=f, g=g, gamma0=gam, tol=1e-8, maxit=5000)
ka = apt.resident_agraal(a, b, x0, xc, gam, 1e-8, 5000, p1=prob.lam)
rd = apt.agraal(torch.zeros(14, dtype=torch.float64), f=fc, g=apt.Zero(), tol=1e-9, maxit=2000)
ag = [[ra.numit, float(f.value(ra.x) + g(ra.x))], [int(ka[1]), float(f.value(ka[0]) + g(ka[0]))],
      [rd.numit, float(fc.value(rd.x))]]
# the dual-SVM slice: the engine's dual branch and Condat-Vu, K6a (plain version) and
# the driver on both paths
from adaprox_tpu_torch.experiments import dual_svm
xs, ys, _ = dual_svm.load("heart_scale")
fq, gb, hz, ao = apt.dsvm_from_numpy(xs, ys, 0.1, device="cpu", dtype=torch.float64)
na = float(np.linalg.norm(ys))
z, zy = torch.zeros(270, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
rp = apt.adaptive_primal_dual(z, zy, f=fq, g=gb, h=hz, A=ao, tol=1e-5, maxit=5000,
                              rule=apt.AdaPGMRule.make(t=0.5, norm_a=na))
rv = apt.condat_vu(z, zy, f=fq, g=gb, h=hz, A=ao, Lf=float(fq.norm_q()), tol=1e-5, maxit=200)
qd, labd, _ = dual_svm.resident_inputs(ys[:, None] * xs, ys, torch.float64, "cpu")
k6 = apt.resident_adapdm_dsvm(qd, labd, 0.1, 0.5, na, 1e-5, 5000, n_true=270)
rm = apt.malitsky_pock(z, zy, f=fq, g=gb, h=hz, A=ao, sigma=1 / na, t=0.5, tol=1e-5, maxit=5000)
k6c = apt.resident_mp_dsvm_sweep(qd, labd, 0.1, [0.5], 1 / na, 1e-5, 5000, n_true=270)
pd = [[rp.numit, float(fq.value(rp.x)), float(ys @ rp.x.numpy()), float(rp.x.min()),
       float(rp.x.max())],
      [int(k6[1]), float(fq.value(k6[0][:270])), float(ys @ k6[0][:270].numpy()),
       float(k6[0].min()), float(k6[0].max())],
      [rv.numit, float(fq.value(rv.x)), float(ys @ rv.x.numpy()), float(rv.x.min()),
       float(rv.x.max())],
      [rm.numit, float(fq.value(rm.x)), float(ys @ rm.x.numpy()), float(rm.x.min()),
       float(rm.x.max())],
      [int(k6c[1][0]), float(fq.value(k6c[0][0][:270])), float(ys @ k6c[0][0][:270].numpy()),
       float(k6c[0].min()), float(k6c[0].max())]]
for path in ([], ["--resident"]):
    dual_svm.main(["--device", "cpu", "--datasets", "heart_scale", "--C", "0.1", "--maxit", "40",
                   "--no-plot", "--outdir", sys.argv[1] + "-dsvm" + "".join(path), *path])
# the square-root lasso slice: the engine's Condat-Vu, K7d (plain version) on the padded
# problem and AdaPDM+ on the least absolute deviation, and its driver on both paths
from adaprox_tpu_torch.experiments import least_absolute_deviation, square_root_lasso
xl, yl, _ = square_root_lasso.load("housing_scale")
fz, gl, hl, al, nal = apt.sqrt_lasso_from_numpy(xl, yl, 10.0, "l1", device="cpu",
                                                dtype=torch.float64)
z14, z506 = torch.zeros(14, dtype=torch.float64), torch.zeros(506, dtype=torch.float64)
rcv = apt.condat_vu(z14, z506, f=fz, g=gl, h=hl, A=al, Lf=0.0, norm_A=nal, tol=1e-5, maxit=300)
apad, bpad = square_root_lasso.resident_inputs(al.a, -hl.b)
k7 = apt.resident_condat_vu(apad, bpad, 10.0, 1 / nal, 0.99 / nal, 1e-5, 300, h_kind="l1")
rpl = apt.adaptive_linesearch_primal_dual(z14, z506, f=fz, g=gl, h=hl, A=al, eta=nal, t=1.0,
                                          tol=1e-5, maxit=300)
rmp = apt.malitsky_pock(z14, z506, f=fz, g=gl, h=hl, A=al, sigma=1.0, t=1.0, tol=1e-5, maxit=300)
kmp = apt.resident_mpls_sweep(apad, bpad, 10.0, [1.0], 1.0, 1e-5, 300, h_kind="l1")
kpd = apt.resident_adapdmp_sweep(apad, bpad, 10.0, [1.0], nal, 1e-5, 300, h_kind="l1")
f0 = [[r_x.shape[0], n_it, float(gl(r_x[:14]) + hl(al.matvec(r_x[:14]))),
       float(r_x[14:].abs().sum())]
      for r_x, n_it in ((rcv.x, rcv.numit), (k7[0], int(k7[1])), (rpl.x, rpl.numit),
                        (rmp.x, rmp.numit), (kmp[0][0], int(kmp[1][0])),
                        (kpd[0][0], int(kpd[1][0])))]
for path in ([], ["--resident"]):
    least_absolute_deviation.main(["--device", "cpu", "--datasets", "housing_scale", "--maxit",
                                   "30", "--no-plot", "--outdir",
                                   sys.argv[1] + "-lad" + "".join(path), *path])
# the dataset grids (K7b's two cores, K7c) on two copies of the padded problem: each
# cell equals the solve on its slice; the driver's --resident-grid wrote its rows
a2, b2 = torch.stack([apad, apad]), torch.stack([bpad, bpad])
g7 = apt.resident_cv_grid(a2, b2, [10.0, 10.0], [1 / nal] * 2, [0.99 / nal] * 2, 1e-5, 300,
                          h_kind="l1")
gmp = apt.resident_mpls_grid(a2, b2, [10.0, 10.0], [1.0], [1.0, 1.0], 1e-5, 300, h_kind="l1")
gpd = apt.resident_adapdmp_grid(a2, b2, [10.0, 10.0], [1.0], [nal, nal], 1e-5, 300, h_kind="l1")
grid = [all(torch.equal(g[k][d], o[k]) for d in range(2) for k in range(4))
        for g, o in ((g7, k7), (gmp, kmp), (gpd, kpd))]
least_absolute_deviation.main(["--device", "cpu", "--datasets", "housing_scale", "--maxit", "30",
                               "--no-plot", "--resident-grid", "--outdir",
                               sys.argv[1] + "-lad--resident-grid"])
# the fused primal-dual slice: fused_condat_vu on the least absolute deviation (A' 14 x 506
# auto-pads to 16 x 512; K5's plain version) against the engine's Condat-Vu above, and the
# driver's --fused
rfv = apt.fused_condat_vu(z14, z506, f=fz, g=gl, h=hl, A=al.a, at=al.a.t().contiguous(),
                          Lf=0.0, norm_A=nal, tol=1e-5, maxit=300)
f0.append([rfv.x.shape[0], rfv.numit, float(gl(rfv.x) + hl(al.matvec(rfv.x))),
           float((rfv.x - rcv.x).abs().max())])
least_absolute_deviation.main(["--device", "cpu", "--datasets", "housing_scale", "--maxit", "30",
                               "--no-plot", "--fused", "--outdir", sys.argv[1] + "-lad--fused"])
# the batched solves: K2b (plain version) over one A expanded to a lambda path, each
# instance against its K2 solve; regularization_path against the engine; the stream
# probes' plain versions against their closed forms; the profiling helpers
from adaprox_tpu_torch.ops import kernels as tkern
from adaprox_tpu_torch.solvers.batch import regularization_path
from adaprox_tpu_torch.utils import profiling
lams = [prob.lam, 2 * prob.lam, 4 * prob.lam]
scal = torch.tensor([[gam, 1e-8, lam, 0.0] for lam in lams], dtype=torch.float64)
kb = apt.resident_adapgm_batch(a.expand(3, *a.shape), b.expand(3, -1).contiguous(),
                               torch.zeros(3, a.shape[1], dtype=torch.float64), scal, 3000)
rpath = regularization_path(torch.zeros(a.shape[1], dtype=torch.float64), f=f, lams=lams,
                            gamma=gam, tol=1e-8, maxit=3000)
r1 = apt.adaptive_proxgrad(torch.zeros(a.shape[1], dtype=torch.float64), f=f,
                           g=apt.L1Norm(torch.tensor(lams[1], dtype=torch.float64)),
                           rule=apt.AdaPGMRule(gamma=gam), tol=1e-8, maxit=3000)
k1 = apt.resident_adapgm(a, b, torch.zeros(a.shape[1], dtype=torch.float64), gam, 1e-8, 3000,
                         p1=lams[1])
sa = torch.arange(64 * 256, dtype=torch.float32).reshape(64, 256) / 4096
batch = [[int(v) for v in kb[1]], [int(v) for v in rpath.numit], r1.numit,
         all(torch.equal(u[1], w) for u, w in zip(kb, k1)),
         bool(torch.equal(rpath.x[1], r1.x)),
         [float(tkern.hbm_read_reduce(sa, scale=2.0, repeats=3)),
          float(tkern.hbm_copy(sa, scale=0.5, block_rows=16)),
          float(tkern.hbm_dma_read(sa, scale=1.0, chunk_rows=16, repeats=2))],
         profiling.throughput_report(2.0, 10, 1e9, device="cpu")["iters_per_sec"]]
with profiling.trace(sys.argv[1] + "-trace"):
    torch.mv(a, torch.ones(a.shape[1], dtype=torch.float64))
import adaprox_tpu_torch.experiments.resident_timing  # the card's timing script
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and k.split(".")[0] in ("jax", "jaxlib", "adaprox_tpu"))
print(json.dumps({"leaked": leaked, "runs": out, "logreg": logreg, "source": src,
                  "cubic": cubic, "bt": bt, "agraal": ag, "pd": pd, "f0": f0, "grid": grid,
                  "batch": batch}))
"""


def test_port_runs_the_slice_without_jax(tmp_path):
    """tests/conftest.py imports jax into this process, so the check runs in
    a fresh interpreter, where jax and the JAX package cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", _SLICE, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    runs = got["runs"]
    assert len(runs) == 12
    for numit, counters, fx in runs[2:]:  # the adaptive rules reach tol 1e-8
        if numit < 3000:
            assert counters[:3] == [numit + 1, numit + 1, numit]
    for numit, _, fx in runs:
        assert np.isfinite(fx)
    # history on or off, the same solve
    for i in range(0, 12, 2):
        assert runs[i] == runs[i + 1]
    adaptive = [r for i, r in enumerate(runs) if i % 6 >= 2]
    optimum = tsyn.random_lasso(m=100, n=300, pfactor=10).optimum
    for numit, _, fx in adaptive:
        assert numit < 3000 and abs(fx - optimum) < 1e-9 * optimum
    # sparse logreg: both LogisticLoss branches and K2's logistic objective reach
    # the same minimum; the driver wrote its JSONL
    assert got["source"] == "synthetic"
    (n0, f0), (n1, f1), (n2, f2) = got["logreg"]
    assert max(n0, n1, n2) < 2000 and abs(f1 - f0) < 1e-12 and abs(f2 - f0) < 1e-9
    # the cubic model: the engine and K2's cubic objective reach the same minimum;
    # the worst case on 10 of 12 coordinates its known optimum (L/8)(1/(k+1) - 1);
    # both drivers wrote their JSONL
    (n3, f3), (n4, f4), (n5, f5) = got["cubic"]
    assert max(n3, n4) < 2000 and n5 < 5000 and abs(f4 - f3) < 1e-9 * abs(f3)
    assert abs(f5 - 12.5 * (1 / 11 - 1)) < 1e-9
    assert (tmp_path / "heart_scale.jsonl").stat().st_size > 0
    assert (tmp_path / "nesterov_worst_case.jsonl").stat().st_size > 0
    # backtracking: the engine, K4 and each K4b row give the same solve (PG reaches
    # tol 1e-8 at the optimum; Nesterov takes all 1000 iterations) and the lasso
    # driver wrote its backtracking rows on both paths
    (n6, f6), (n7, f7), (n8, f8), (n9, f9), (n10, f10), (n11, f11) = got["bt"]
    assert n6 == n8 == n10 < 1000 and n7 == n9 == n11 == 1000
    assert f6 == f8 == f10 and f7 == f9 == f11 and abs(f6 - optimum) < 1e-9 * optimum
    for path in ("--fused", "--resident"):
        rows = tlog.read_jsonl(tmp_path.parent / (tmp_path.name + path) / "lasso_64_128_8.jsonl")
        assert {r.get("method") for r in rows if "it" in r} >= {"Nesterov (backtracking)",
                                                                 "aGRAAL"}
    # aGRAAL: the engine and K4's aGRAAL core from the same companion point reach the
    # optimum at the same iteration; the engine's own draw reaches the cubic minimum;
    # the cubic driver wrote its aGRAAL row
    (n12, f12), (n13, f13), (n14, f14) = got["agraal"]
    assert n12 == n13 < 5000 and abs(f12 - optimum) < 1e-9 * optimum and abs(f13 - f12) < 1e-12
    assert n14 < 2000 and abs(f14 - f3) < 1e-9 * abs(f3)
    rows = tlog.read_jsonl(tmp_path / "heart_scale.jsonl")
    assert "aGRAAL" in {r.get("method") for r in rows if "it" in r}
    # the dual SVM: the engine's AdaPDM and K6a's plain version, the engine's
    # Malitsky-Pock and K6c's plain version converge to the same feasible point;
    # Condat-Vu stays in the box; the driver wrote both paths' JSONL, all 25 rows
    (n15, f15, e15, lo15, hi15), (n16, f16, e16, lo16, hi16), (n17, _, _, lo17, hi17), \
        (n18, f18, e18, lo18, hi18), (n19, f19, e19, lo19, hi19) = got["pd"]
    assert n15 < 5000 and n16 < 5000 and abs(n15 - n16) <= 0.1 * n15 and n17 == 200
    assert n18 < 5000 and n19 < 5000 and abs(n18 - n19) <= 0.1 * n18
    assert abs(f16 - f15) < 1e-6 * abs(f15) and max(abs(e15), abs(e16)) < 1e-5
    assert max(abs(f18 - f15), abs(f19 - f15)) < 1e-6 * abs(f15)
    assert max(abs(e18), abs(e19)) < 1e-5
    assert min(lo15, lo16, lo17, lo18, lo19) >= 0.0 and max(hi15, hi16, hi17, hi18, hi19) <= 0.1
    for path in ("", "--resident"):
        rows = tlog.read_jsonl(tmp_path.parent / (tmp_path.name + "-dsvm" + path)
                               / "heart_scale_C_0.1.jsonl")
        last = [r["method"] for r in rows if r.get("it") == 40]
        assert len(last) == 25 and last[12] == "Malitsky-Pock (t=0.01)" and last[-1] == "Condat-Vu"
    # the least absolute deviation: the engine's Condat-Vu, Malitsky-Pock and AdaPDM+
    # and the plain versions of K7d and K7a's two cores on A padded to 512 x 128 take the
    # same iterations to the same objective, the padded coordinates 0; the driver wrote
    # its 31 rows on every path, --fused among them
    (n20, i20, f20, _), (n21, i21, f21, p21), (n22, i22, f22, _) = got["f0"][:3]
    (n23, i23, f23, _), (n24, i24, f24, p24), (n25, i25, f25, p25) = got["f0"][3:6]
    # fused_condat_vu: the engine's Condat-Vu iterate, x at its own 14 coordinates
    (n26, i26, f26, d26), = got["f0"][6:]
    assert n26 == 14 and i26 == i20 and abs(f26 - f20) < 1e-12 * abs(f20) and d26 < 1e-12
    assert (n20, n21, n22, n23, n24, n25) == (14, 128, 14, 14, 128, 128)
    assert i20 == i21 == i22 == i23 == i24 == i25 == 300 and p21 == p24 == p25 == 0.0
    assert abs(f21 - f20) < 1e-9 * abs(f20) and np.isfinite(f22)
    assert abs(f24 - f23) < 1e-9 * abs(f23) and abs(f25 - f22) < 1e-9 * abs(f22)
    # the dataset grids: every cell equals the solve on its slice (K7c, K7b's two cores)
    assert got["grid"] == [True, True, True]
    for path, names in (("", 31), ("--resident", 31), ("--resident-grid", 31), ("--fused", 31)):
        rows = tlog.read_jsonl(tmp_path.parent / (tmp_path.name + "-lad" + path)
                               / "housing_scale.jsonl")
        counts = {}
        for r in rows:
            if "norm_res" in r:
                counts[r["method"]] = counts.get(r["method"], 0) + 1
        assert len(counts) == names and set(counts.values()) == {30}
    # the batched solves: K2b's instances are their K2 solves, the path's middle slice
    # the engine's solve; every lambda converges; the probes give their closed forms
    kb_numit, path_numit, engine_numit, k2b_is_k2, path_is_engine, probes, ips = got["batch"]
    assert k2b_is_k2 and path_is_engine and path_numit[1] == engine_numit
    assert max(kb_numit) < 3000 and max(path_numit) < 3000
    sa = np.arange(64 * 256, dtype=np.float64).reshape(64, 256) / 4096
    want = [3 * 2.0 * sa.sum(), 0.5 * (sa[0, :128].sum() + sa[-1, -128:].sum()),
            128.0 + 2 * sa[::16, :128].sum()]
    np.testing.assert_allclose(probes, want, rtol=1e-5)
    assert ips == 5.0
    assert len(list(tmp_path.parent.glob(tmp_path.name + "-trace/trace_*.json"))) == 1


# -- (h) chip_smoke.py ---------------------------------------------------------


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    tops = {m.split(".")[0] for m in mods}
    assert "jax" not in tops and "adaprox_tpu" not in tops
    assert "adaprox_tpu_torch" in tops


def test_chip_smoke_reads_the_ptxas_report():
    """The [build] line names each kernel instantiation with its registers,
    stack bytes and spill-store bytes, from nvcc's -Xptxas -v output."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ns = "_ZN47_GLOBAL__N__1323a1fc_14_resident_pg_cu_550c6022"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{ns}24resident_pg_sweep_kernelI13__nv_bfloat16"
        "Li8ELi1EEEvNS_7ProblemENS_4RowsE' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    8 bytes stack frame, 10 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size",
        f"ptxas info    : Compiling entry function '{ns}18resident_pg_kernelILi0EfLi4ELi4EEEvNS_7"
        "ProblemENS_5SolveE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 512 bytes smem",
        "ptxas info    : Compiling entry function '_Z14plain_reduce_kernelPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert smoke.ptxas_report(log) == ["resident_pg_sweep_kernel<bf16,8,1> 128/8/10",
                                       "resident_pg_kernel<0,f32,4,4> 96/0/0",
                                       "_Z14plain_reduce_kernelPf 32/0/0"]


def test_resident_timing_needs_a_card():
    from adaprox_tpu_torch.experiments import resident_timing

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        resident_timing.main([])


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA it must exit non-zero and print no result; likewise in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
