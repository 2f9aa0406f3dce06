"""The port's lasso path as a whole: its numpy-only copies against the JAX
package's originals, its driver's JSONL against the JAX driver's, the port
running without JAX, and chip_smoke.py refusing to run without a card."""

import ast
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
MENU = ("PGM (fixed)", "AdaPGM (MM)", "AdaPGM (Ours)")


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
    """Three rows, --device cpu (f64), against the JAX driver's JSONL filtered
    to those rows. 20 iterations: inside the horizon where the adaptive
    rules' step sizes agree to 1e-9 (see test_torch_engine.py); measured
    9e-14."""
    args = ["--sizes", "64x96x8", "--maxit", "20", "--no-plot", "--fused"]
    jlasso.main(["--outdir", str(tmp_path / "jax"), *args])
    tlasso.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    assert "skipping rows not ported yet" in capsys.readouterr().out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "lasso_64_96_8.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "lasso_64_96_8.jsonl")
    assert trows[0] == jrows[0]  # the analytic-optimum pseudo record
    jm = [r for r in jrows if r.get("method") in MENU]
    tm = [r for r in trows if r.get("method") is not None]
    assert len(tm) == len(jm) == 3 * 20
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
    assert sorted(tmeta["wall_s"]) == sorted(MENU) == tmeta["fast_methods"]


def test_lasso_driver_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlasso.main(["--outdir", str(tmp_path), "--sizes", "8x16x2", "--no-plot"])


# -- (g) the port runs without JAX ------------------------------------------


_SLICE = r"""
import json, sys
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
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "adaprox_tpu"))
print(json.dumps({"leaked": leaked, "runs": out}))
"""


def test_port_runs_the_slice_without_jax():
    """tests/conftest.py imports jax into this process, so the check runs in
    a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _SLICE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
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


# -- (h) chip_smoke.py ---------------------------------------------------------


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    tops = {m.split(".")[0] for m in mods}
    assert "jax" not in tops and "adaprox_tpu" not in tops
    assert "adaprox_tpu_torch" in tops


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
