"""The sparse-logistic-regression path of the PyTorch port against the JAX
package, on the same numpy inputs (f64 on the CPU unless a test says
otherwise): the LIBSVM loader and the datasets (numpy-only copies),
``LogisticLoss`` with K3's plain version, the engine on a logistic problem,
the logistic objective of K2 and K2c (plain versions), and the
``sparse_logreg`` driver.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_kernels.py does; the port's wrappers take their plain versions on
CPU tensors. The CUDA kernels are tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py.

No test here reaches the network: the JAX package's dataset loader would try
to download a missing file, so its download is replaced by one that fails
as it does without a network (``no_download``).

About the horizons (see tests/test_torch_engine.py for the mechanism). On
the logistic problems below the adaptive rules amplify the summation-order
difference between the two sides as on the lasso: on the heart_scale
driver's rows the first relative difference past 1e-11 came at iteration 25
(AdaPGM and the ground truth) and 35 (MM) on the engine path, and at 21 and
25 through the sweep; never for the fixed step and Nesterov (measured on the
CPU in f64). Rows are held to rtol 1e-9 over horizons below those.
"""

import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

import adaprox_tpu as ap
import adaprox_tpu.utils.datasets as jds
import adaprox_tpu.utils.libsvm as jlibsvm
import adaprox_tpu_torch as apt
import adaprox_tpu_torch.utils.datasets as tds
import adaprox_tpu_torch.utils.libsvm as tlibsvm
import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import sparse_logreg as jdriver
from adaprox_tpu.models.objectives import LogisticLoss as JLogisticLoss
from adaprox_tpu.ops import kernels as jk
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import sparse_logreg as tdriver
from adaprox_tpu_torch.ops import kernels as tk
from adaprox_tpu_torch.ops import resident as tr

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective")


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def logreg_case(m=60, n_feat=13, seed=0, pad=(64, 128)):
    """A sparse binary problem: [X 1] zero-padded to ``pad`` (the drivers'
    tile padding), labels padded with 0, and gamma0 = 1/Lf with the
    reference's Frobenius Lf (runme.jl:58-59)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n_feat)) * (rng.random((m, n_feat)) < 0.5)
    y = (x @ rng.standard_normal(n_feat) + 0.5 * rng.standard_normal(m) > 0).astype(float)
    x1 = np.zeros(pad)
    x1[:m, :n_feat] = x
    x1[:m, n_feat] = 1.0
    y_pad = np.zeros(pad[0])
    y_pad[:m] = y
    return x, y, x1, y_pad, 1.0 / tdriver.lipschitz_estimate(x)


# -- the numpy-only copies -------------------------------------------------------

LIBSVM_TEXT = """+1 1:0.5 3:-1.25 7:2
-1 2:1 3:0.75

+1 7:-0.5
-1 1:1e-3 4:4
"""


@pytest.mark.parametrize("kw", [
    dict(), dict(labels=(0.0, 1.0)), dict(labels=(-1.0, 1.0)), dict(pad_to=8),
    dict(labels=(0.0, 1.0), pad_to=4), dict(n_features=10), dict(n_features=3),
    dict(dtype=np.float32, labels=(0.0, 1.0)),
])
def test_libsvm_loader_matches_jax(tmp_path, kw):
    path = tmp_path / "toy.libsvm"
    path.write_text(LIBSVM_TEXT)
    want = jlibsvm.load_libsvm_dataset(path, engine="python", **kw)
    for engine in ("python", "auto"):
        got = tlibsvm.load_libsvm_dataset(path, engine=engine, **kw)
        assert len(got) == len(want)
        for u, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert u.dtype == w.dtype and u.shape == w.shape and u.tobytes() == w.tobytes()
            else:
                assert u == w
    assert tlibsvm.round_up(13, 8) == jlibsvm.round_up(13, 8) == 16


@pytest.mark.parametrize("text,match", [("1 0:1\n", "feature index 0 < 1"),
                                        ("1 -2:1\n", "feature index -2 < 1")])
def test_libsvm_loaders_reject_indices_below_one(tmp_path, text, match):
    path = tmp_path / "bad.libsvm"
    path.write_text(text)
    for load in (jlibsvm.load_libsvm_dataset, tlibsvm.load_libsvm_dataset):
        with pytest.raises(ValueError, match=match):
            load(path, engine="python")


def test_libsvm_loader_refuses_what_is_not_ported(tmp_path):
    path = tmp_path / "toy.libsvm"
    path.write_text(LIBSVM_TEXT)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlibsvm.load_libsvm_dataset(path, engine="native")
    for kw, match in ((dict(engine="nope"), "unknown engine"),
                      (dict(labels=(1.0, 1.0)), "two distinct")):
        for load in (jlibsvm.load_libsvm_dataset, tlibsvm.load_libsvm_dataset):
            with pytest.raises(ValueError, match=match):
                load(path, **kw)


@pytest.mark.parametrize("name", sorted(jds.DATASET_SHAPES))
def test_synthetic_datasets_are_bit_identical(name, tmp_path, no_download):
    assert tds.DATASET_SHAPES == jds.DATASET_SHAPES and tds.DATASET_URLS == jds.DATASET_URLS
    labels = (0.0, 1.0) if jds.DATASET_SHAPES[name][2] else None
    want = jds.load_or_synthesize(name, labels=labels, local_dir=str(tmp_path / "j"))
    got = tds.load_or_synthesize(name, labels=labels, local_dir=str(tmp_path / "t"))
    assert got[2] == want[2] == "synthetic"
    m, n, _ = jds.DATASET_SHAPES[name]
    assert got[0].shape == (m, n)
    for u, w in zip(got[:2], want[:2]):
        assert u.dtype == w.dtype and u.tobytes() == w.tobytes()


def test_datasets_read_a_local_file_like_jax(tmp_path, capsys, no_download):
    """A file in the directory is read (source "libsvm"); one that does not
    parse falls back to synthetic data on both sides, with the same printed
    reason. Neither case downloads anything."""
    (tmp_path / "heart_scale").write_text(LIBSVM_TEXT)
    want = jds.load_or_synthesize("heart_scale", labels=(0.0, 1.0), local_dir=str(tmp_path))
    got = tds.load_or_synthesize("heart_scale", labels=(0.0, 1.0), local_dir=str(tmp_path))
    assert got[2] == want[2] == "libsvm"
    for u, w in zip(got[:2], want[:2]):
        assert u.tobytes() == w.tobytes()
    (tmp_path / "heart_scale").write_text("1 0:1\n")
    capsys.readouterr()
    jds.load_or_synthesize("heart_scale", local_dir=str(tmp_path))
    said_j = capsys.readouterr().out
    got = tds.load_or_synthesize("heart_scale", local_dir=str(tmp_path))
    said_t = capsys.readouterr().out
    assert got[2] == "synthetic" and "real-data load failed" in said_t and said_t == said_j
    assert tds.default_dataset_dir() and tds.dataset_path("heart_scale", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tds.dataset_path("a5a", str(tmp_path))


# -- K3 and LogisticLoss ------------------------------------------------------------------

K3_SHAPES = [(64, 128), (96, 256), (256, 384)]  # tile-aligned: the Pallas kernel needs it


def _k3_inputs(m, n, seed=0):
    rng = np.random.default_rng(seed)
    return (gaussian(seed, m, n) / np.sqrt(n), (rng.random(m) < 0.4).astype(float),
            gaussian(seed + 1, n), 0.3)


@pytest.mark.parametrize("m,n", K3_SHAPES)
@pytest.mark.parametrize("store", ["float64", "float32", "bfloat16"])
def test_k3_plain_matches_jax_interpret_kernel(m, n, store):
    x, y, w, wb = _k3_inputs(m, n)
    vec = "float64" if store == "float64" else "float32"
    x_j = jnp.asarray(x, store)
    x_t = torch.from_numpy(x).to(getattr(torch, store))
    # bf16 storage: both sides start from the same rounded values
    np.testing.assert_array_equal(np.asarray(x_j.astype(jnp.float64)), x_t.double().numpy())
    f_j, gw_j, gb_j = jk.fused_logistic_value_grad(
        x_j, jnp.asarray(y, vec), jnp.asarray(w, vec), jnp.asarray(wb, vec), interpret=True)
    vec_t = getattr(torch, vec)
    args = (torch.from_numpy(y).to(vec_t), torch.from_numpy(w).to(vec_t),
            torch.tensor(wb, dtype=vec_t))
    launches = tk.fused_logistic_value_grad.launches
    for f_t, gw_t, gb_t in (tk.logistic_value_grad_plain(x_t, *args),
                            tk.fused_logistic_value_grad(x_t, *args)):
        assert f_t.dtype == gw_t.dtype == gb_t.dtype == args[1].dtype and gw_t.shape == (n,)
        # the sums run in another order: ~(m + n) eps in f64, and eps = 6e-8 in
        # f32 (bf16 storage accumulates in f32 too)
        rtol = 1e-12 if vec == "float64" else 1e-5
        np.testing.assert_allclose(float(f_t), float(f_j), rtol=rtol)
        np.testing.assert_allclose(float(gb_t), float(gb_j), rtol=0, atol=rtol * abs(float(gb_j)))
        g_ref = np_of(gw_j)
        np.testing.assert_allclose(np_of(gw_t), g_ref, rtol=0, atol=rtol * np.abs(g_ref).max())
    # CPU tensors take the plain version: no kernel launch is counted
    assert tk.fused_logistic_value_grad.launches == launches


@pytest.mark.parametrize("m,n", [(1, 1), (7, 5), (999, 301)])
def test_k3_plain_any_shape_matches_numpy(m, n):
    """The CUDA kernel takes any (m, n); its plain version does too."""
    x, y, w, wb = _k3_inputs(m, n, seed=3)
    f, gw, gb = tk.fused_logistic_value_grad(torch.from_numpy(x), torch.from_numpy(y),
                                             torch.from_numpy(w), torch.tensor(wb, dtype=F64))
    z = x @ w + wb
    p = 1.0 / (1.0 + np.exp(-z))
    np.testing.assert_allclose(float(f), -np.mean((y - 1) * z - np.logaddexp(0, -z)),
                               rtol=1e-12)
    np.testing.assert_allclose(np_of(gw), x.T @ (p - y) / m, rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(float(gb), np.mean(p - y), rtol=1e-11, atol=1e-15)


def test_k3_wrapper_rejects_bad_arguments():
    x, y, w, wb = (torch.as_tensor(v) for v in _k3_inputs(8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        tk.fused_logistic_value_grad(x, y[:-1], w, wb)
    with pytest.raises(ValueError, match="need x_mat"):
        tk.fused_logistic_value_grad(x, y, w, wb[None])
    # neither CPU nor CUDA: no plain fall-back, no kernel
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        tk.fused_logistic_value_grad(*(t.to("meta") for t in (x, y, w, wb)))
    with pytest.raises(ValueError, match="different devices"):
        tk.fused_logistic_value_grad(x, y.to("meta"), w, wb)


def test_k3_source_and_build_key():
    """K3 is built from its own CUDA source for sm_90a, with no library
    kernel standing in for the hand-written one."""
    src = tk.LOGISTIC_SOURCE.read_text()
    assert "__global__" in src and "adaprox_fused_logistic" in src
    assert tk.LOGISTIC_SOURCE.parent == tk.SOURCE.parent and tk.LOGISTIC_SOURCE != tk.SOURCE
    body = src.split("#include <stdint.h>", 1)[1]
    for banned in ("cublas", "wmma", "mma.sync", "torch", "__expf", "use_fast_math"):
        assert banned not in body


@pytest.mark.parametrize("shape,itemsize", [
    ((64, 128), 4), ((64, 128), 2), ((72, 128), 2), ((8128, 128), 4), ((8128, 128), 2),
    ((60, 128), 4), ((64, 130), 4), ((6416, 128), 8), ((16384, 16384), 4), ((3, 5), 4),
])
def test_fused_gate_matches_jax(shape, itemsize):
    """The JAX package takes its fused Pallas oracle only where its TPU tiling
    rule holds (``ls_supported``) and the two-matvec branch elsewhere. K3 has
    no such limit, so the port's ``fused=True`` calls K3 at every shape, on
    each side of that rule: here on meta tensors, which K3's wrapper refuses
    (neither CPU nor CUDA) where any other branch would run."""
    dtype = {8: "float64", 4: "float32", 2: "bfloat16"}[itemsize]
    jax_fuses = jk.ls_supported(jax.ShapeDtypeStruct(shape, dtype), None, None)
    assert jax_fuses == (shape[1] % 128 == 0 and shape[0] % (16 if itemsize == 2 else 8) == 0)
    x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    y = torch.empty(shape[0], dtype=x.dtype, device="meta")
    w = torch.empty(shape[1] + 1, dtype=x.dtype, device="meta")
    with pytest.raises(ValueError, match="K3 runs on CPU .* or CUDA tensors, not meta"):
        apt.LogisticLoss(x, y, fused=True).value_and_aux(w)
    assert apt.LogisticLoss(x, y).value_and_aux(w)[1].shape == (shape[0],)  # two matvecs


@pytest.mark.parametrize("shape", [(64, 128), (60, 13)])  # JAX's fused branch taken, and not
@pytest.mark.parametrize("fused", [False, True])
def test_logistic_loss_matches_jax(fused, shape):
    m, n = shape
    x, y, _, _ = _k3_inputs(m, n, seed=5)
    w = gaussian(6, n + 1)
    fj = JLogisticLoss(x=jnp.asarray(x), y=jnp.asarray(y), fused=fused)
    ft, gt = apt.logreg_from_numpy(x, y, 0.01, device="cpu", dtype=F64, fused=fused)
    assert dict(ft.named_buffers()).keys() == {"x", "y"} and float(gt.lam) == 0.01
    assert fj._use_fused() == (fused and shape == (64, 128))
    vj, auxj = fj.value_and_aux(jnp.asarray(w))
    vt, auxt = ft.value_and_aux(torch.from_numpy(w))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
    # the port's fused aux is the gradient (n + 1,) at every shape, the other
    # branch's the probabilities (m,); JAX's follows its tiling rule
    assert auxt.shape == ((n + 1,) if fused else (m,))
    if auxt.shape == np_of(auxj).shape:
        np.testing.assert_allclose(np_of(auxt), np_of(auxj), rtol=0,
                                   atol=1e-12 * np.abs(np_of(auxj)).max())
    gj, gtt = np_of(fj.grad(jnp.asarray(w))), np_of(ft.grad(torch.from_numpy(w)))
    np.testing.assert_allclose(gtt, gj, rtol=0, atol=1e-12 * np.abs(gj).max())
    assert float(ft(torch.from_numpy(w))) == float(vt)  # nn.Module call = value
    assert ft.bregman_from_aux(None, auxt, auxt) is None  # no better form, as in JAX


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_logistic_loss_f32_matches_jax(store):
    """f32 iterates (bf16 storage accumulates in f32): within 1e-5."""
    x, y, _, _ = _k3_inputs(64, 128, seed=7)
    w = gaussian(8, 129).astype(np.float32)
    ft, _ = apt.logreg_from_numpy(x, y, 0.01, device="cpu", dtype=store, fused=True)
    assert ft.x.dtype == store and ft.y.dtype == torch.float32
    x_j = jnp.asarray(x, {torch.float32: "float32", torch.bfloat16: "bfloat16"}[store])
    fj = JLogisticLoss(x=x_j, y=jnp.asarray(y, "float32"), fused=True)
    vj, gj = fj.value_and_grad(jnp.asarray(w))
    vt, gt = ft.value_and_grad(torch.from_numpy(w))
    assert vt.dtype == gt.dtype == torch.float32
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    np.testing.assert_allclose(np_of(gt), np_of(gj), rtol=0, atol=1e-5 * np.abs(np_of(gj)).max())


# -- the engine on a logistic problem -----------------------------------------------------


def _engine(side, kind, fused, tol, maxit, history=True):
    x, y, _, _, gamma0 = logreg_case()
    # tile-aligned X, so both sides take their fused branch when asked
    xp, yp = np.zeros((64, 128)), np.zeros(64)
    xp[:60, :13], yp[:60] = x, y
    if side == "jax":
        f, g = JLogisticLoss(x=jnp.asarray(xp), y=jnp.asarray(yp), fused=fused), ap.L1Norm(lam=0.01)
        mod, x0 = ap, jnp.zeros(129)
    else:
        f, g = apt.logreg_from_numpy(xp, yp, 0.01, device="cpu", dtype=F64, fused=fused)
        mod, x0 = apt, torch.zeros(129, dtype=F64)
    kw = dict(f=f, g=g, tol=tol, maxit=maxit, history=history)
    if kind == "fixed":
        return mod.fixed_proxgrad(x0, gamma=gamma0, **kw), f, g
    rule = (mod.MalitskyMishchenkoRule if kind == "mm" else mod.AdaPGMRule)(gamma=gamma0)
    return mod.adaptive_proxgrad(x0, rule=rule, **kw), f, g


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,horizon", [("fixed", 200), ("mm", 30), ("adapgm", 20)])
def test_engine_logreg_rows_match_jax(kind, horizon, fused):
    rj, _, _ = _engine("jax", kind, fused, 0.0, horizon)
    rt, _, _ = _engine("torch", kind, fused, 0.0, horizon)
    assert rt.numit == int(rj.numit) == horizon
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    for k in ("gamma", "norm_res", "objective"):
        np.testing.assert_allclose(np_of(getattr(rt.records, k)), np_of(getattr(rj.records, k)),
                                   rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np_of(rj.x)).max())


@pytest.mark.parametrize("kind", ["mm", "adapgm"])
def test_engine_logreg_converges_to_jax_solution(kind):
    tol = 1e-9
    rj, fj, gj = _engine("jax", kind, False, tol, 5000, history=False)
    rt, ft, gt = _engine("torch", kind, False, tol, 5000, history=False)
    for r in (rj, rt):
        assert int(r.numit) < 5000 and float(r.norm_res) <= tol
    assert abs(rt.numit - int(rj.numit)) <= max(25, int(rj.numit) // 10)
    xj, xt = np_of(rj.x), np_of(rt.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-7 * np.abs(xj).max())
    np.testing.assert_allclose(float(ft.value(rt.x) + gt(rt.x)), float(fj.value(rj.x) + gj(rj.x)),
                               rtol=1e-12)


# -- K2 and K2c with the logistic objective ----------------------------------------------


def _k2_both(tol, maxit, **kw):
    _, _, x1, y_pad, gamma0 = logreg_case()
    oj = jr.resident_logreg_l1(jnp.asarray(x1), jnp.asarray(y_pad), jnp.zeros(128), gamma0, 0.01,
                               tol, maxit, interpret=True, **kw)
    ot = tr.resident_logreg_l1(torch.from_numpy(x1), torch.from_numpy(y_pad),
                               torch.zeros(128, dtype=F64), gamma0, 0.01, tol, maxit, **kw)
    return [np_of(v) for v in oj], [np_of(v) for v in ot]


@pytest.mark.parametrize("m_true", [60.0, None])  # the padded rows corrected, and counted
@pytest.mark.parametrize("rule,momentum,horizon", [
    ("adapgm", False, 20), ("mm", False, 30), ("fixed", False, 100), ("fixed", True, 100)])
def test_k2_logreg_matches_jax(rule, momentum, horizon, m_true):
    kw = dict(m_true=m_true, rule_kind=rule, momentum=momentum)
    launches = tr.resident_adapgm.launches
    oj, ot = _k2_both(0.0, horizon, record=True, **kw)
    assert tr.resident_adapgm.launches == launches  # CPU tensors: the plain version
    assert int(ot[1]) == int(oj[1]) == horizon and not ot[3] and not oj[3]
    for k, name in enumerate(HIST, start=4):
        np.testing.assert_allclose(ot[k], oj[k], rtol=1e-9, err_msg=name)
    assert float(ot[2]) == pytest.approx(float(oj[2]), rel=1e-6)  # f32 stats on both sides
    np.testing.assert_allclose(ot[0], oj[0], rtol=1e-9, atol=1e-9 * np.abs(oj[0]).max())
    # without records: the same solve
    _, plain = _k2_both(0.0, horizon, **kw)
    for u, w in zip(plain, ot[:4]):
        np.testing.assert_array_equal(u, w)


def test_k2_logreg_objective_is_the_mean_over_true_rows():
    """Each zero-padded row has logit 0 and adds log 2 to the loss sum: with
    m_true it is taken out and the mean runs over the true rows; without,
    the padded rows count in the mean."""
    x, y, x1, y_pad, _ = logreg_case()
    a, b = torch.from_numpy(x1), torch.from_numpy(y_pad)
    w = gaussian(9, 128) * (np.arange(128) < 14)
    z = np.hstack([x, np.ones((60, 1))]) @ w[:14]
    f_true = np.mean(np.logaddexp(0, -z) - (y - 1) * z)
    for m_true, want in ((60.0, f_true), (None, (60 * f_true + 4 * np.log(2.0)) / 64)):
        val_aux_of, _ = tr._obj_split(a, tr._transposed(a, "logreg", m_true), b, "logreg",
                                      m_true)
        assert float(val_aux_of(torch.from_numpy(w))[0]) == pytest.approx(want, rel=1e-13)


def test_k2_logreg_converges_like_jax():
    oj, ot = _k2_both(1e-7, 3000)
    assert bool(ot[3]) and bool(oj[3])
    numit = int(oj[1])
    assert numit < 3000 and abs(int(ot[1]) - numit) <= max(25, numit // 10)
    np.testing.assert_allclose(ot[0], oj[0], rtol=0, atol=1e-6 * np.abs(oj[0]).max())
    assert not ot[0][14:].any()  # the padded columns stay exactly 0


def _driver_rows(gamma0, tol, maxit):
    return jr.rule_rows(tdriver.rule_specs(gamma0, tol, maxit))


def test_k2c_logreg_matches_jax_sweep():
    """The five driver rows (ground truth at tol/10 with cap maxit x 10, the
    half-budget Nesterov row) through JAX's sweep and the port's."""
    _, _, x1, y_pad, gamma0 = logreg_case()
    tol, maxit = 1e-7, 60
    rows = _driver_rows(gamma0, tol, maxit)
    np.testing.assert_array_equal(
        tr.rule_rows(tdriver.rule_specs(gamma0, tol, maxit)), rows)
    kw = dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=60.0)
    xj, itj, _, cj, hj = jr.resident_rule_sweep(jnp.asarray(x1), jnp.asarray(y_pad),
                                                jnp.zeros(128), rows, tol, maxit * 10,
                                                interpret=True, **kw)
    launches = tr.resident_rule_sweep.launches
    xt, itt, _, ct, ht = tr.resident_rule_sweep(torch.from_numpy(x1), torch.from_numpy(y_pad),
                                                torch.zeros(128, dtype=F64), rows, tol, maxit * 10,
                                                **kw)
    assert tr.resident_rule_sweep.launches == launches  # CPU tensors: the plain version
    horizon = {"adapgm": 20, "mm": 25, "fixed": maxit}
    for j, (name, rule, mom) in enumerate(tdriver.RESIDENT_ROWS):
        cap = int(rows[j, 4])
        numit = int(itj[j])
        assert abs(int(itt[j]) - numit) <= max(25, numit // 10) and int(itt[j]) <= cap, name
        assert bool(ct[j]) == bool(cj[j])
        h = min(horizon[rule], numit)
        for k in range(3):
            np.testing.assert_allclose(np_of(ht[k][j])[:h], np_of(hj[k][j])[:h], rtol=1e-9,
                                       err_msg=f"{name} {HIST[k]}")
            assert not np_of(ht[k][j])[cap:].any()
    # each row of the sweep is its single plain solve, bit for bit
    for j, (g0, r, mom, t, cap) in enumerate(rows.tolist()):
        one = tr.resident_logreg_l1(torch.from_numpy(x1), torch.from_numpy(y_pad),
                                    torch.zeros(128, dtype=F64), g0, 0.01, t, int(cap),
                                    m_true=60.0, rule_kind=tr._RULE_OF_IDX[int(r)],
                                    momentum=mom > 0, record=True)
        assert torch.equal(xt[j], one[0]) and int(itt[j]) == int(one[1])
        assert all(torch.equal(ht[k][j][:int(cap)], one[4 + k]) for k in range(3))


@pytest.mark.parametrize("entry", ["single", "sweep"])
@pytest.mark.parametrize("m_true", [0.0, 65.0])
def test_logreg_refuses_a_bad_m_true(entry, m_true):
    _, _, x1, y_pad, gamma0 = logreg_case()
    args = (torch.from_numpy(x1), torch.from_numpy(y_pad), torch.zeros(128, dtype=F64))
    with pytest.raises(ValueError, match="m_true must be in"):
        if entry == "single":
            tr.resident_logreg_l1(*args, gamma0, 0.01, 0.0, 5, m_true=m_true)
        else:
            tr.resident_rule_sweep(*args, _driver_rows(gamma0, 0.0, 5), 0.0, 50,
                                   obj_kind="logreg", m_true=m_true)


# -- the driver ------------------------------------------------------------------------------

# the first relative differences past 1e-11 (module docstring) come at 25 and 35
# iterations on the engine path, 21 and 25 through the sweep; the backtracking rows
# (30 iterations at maxit 60) agreed to the end, trial counts and all
BT_NAMES = [name for name, _, _ in tdriver.BT_ROWS]
DRIVER_HORIZON = {None: 20, "PGM (1/Lf)": 60, "Nesterov (fixed)": 30, "AdaPGM (MM)": 25,
                  "AdaPGM (Ours)": 20, **{name: 30 for name in BT_NAMES}, "aGRAAL": 20}
RULE_NAMES = [name for name, _, _ in tdriver.RESIDENT_ROWS]


def _by_method(rows):
    by = {}
    for r in rows:
        if "it" in r:
            by.setdefault(r.get("method"), []).append(r)
    return by


@pytest.mark.parametrize("path", ["default", "resident"])
def test_driver_jsonl_matches_jax(tmp_path, capsys, no_download, path):
    """heart_scale (its synthetic stand-in, 270x13), maxit 60, f64, against
    the JAX driver's JSONL filtered to the ported rows, row for row over the
    horizons. The JAX ``--resident`` side runs its sweeps in interpret mode
    (a few seconds)."""
    args = ["--datasets", "heart_scale", "--maxit", "60", "--no-plot"]
    args += ["--resident"] if path == "resident" else []
    jdriver.main(["--outdir", str(tmp_path / "jax"), *args])
    capsys.readouterr()
    tdriver.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    out = capsys.readouterr().out
    assert "skipping rows not ported yet" not in out and "falling back" not in out
    jrows = tlog.read_jsonl(tmp_path / "jax" / "heart_scale.jsonl")
    trows = tlog.read_jsonl(tmp_path / "torch" / "heart_scale.jsonl")
    jby, tby = _by_method(jrows), _by_method(trows)
    assert list(tby) == list(jby) == RULE_NAMES[:2] + BT_NAMES + RULE_NAMES[2:] + ["aGRAAL"]
    # the ground truth is logged with method null (the JAX package's native
    # sink drops the key instead; its Python writer writes null)
    assert trows[0]["method"] is None and list(trows[0])[0] == "method"
    for name, rows in tby.items():
        want = jby[name]
        numit = len(want)
        assert abs(len(rows) - numit) <= max(25, numit // 10), name
        for rt, rj in list(zip(rows, want))[:DRIVER_HORIZON[name]]:
            assert [k for k in rt if k != "method"] == [k for k in rj if k != "method"]
            for k, v in rj.items():
                if isinstance(v, float):
                    assert rt[k] == pytest.approx(v, rel=1e-9), (name, k)
                else:
                    assert rt[k] == v, (name, k)
    tmeta = [r for r in trows if "it" not in r]
    jmeta = [r for r in jrows if "it" not in r]
    names = ["(ground truth)"] + RULE_NAMES[1:2] + BT_NAMES + RULE_NAMES[2:] + ["aGRAAL"]
    if path == "resident":
        assert list(tmeta[0]) == ["grid_total_s"] and list(tmeta[0]["grid_total_s"]) == [
            "bt sweep", "rule sweep"] == list(jmeta[0]["grid_total_s"])
        tmeta, jmeta = tmeta[1:], jmeta[1:]
        # each sweep's rows share its wall, the backtracking rows first (as in JAX)
        names = BT_NAMES + ["(ground truth)"] + RULE_NAMES[1:] + ["aGRAAL"]
    assert [list(r) for r in tmeta] == [list(r) for r in jmeta] == [
        ["wall_s", "fast_path", "fast_methods"], ["data_source"]]
    assert list(tmeta[0]["wall_s"]) == list(jmeta[0]["wall_s"]) == names
    assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == path
    assert tmeta[0]["fast_methods"] == (sorted(names) if path == "resident" else [])
    assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}


def test_driver_resident_is_one_sweep(tmp_path, monkeypatch):
    """``--resident`` runs the five rule rows as one rule-sweep call, with the
    driver's per-row tol and caps and the logistic objective, and the four
    backtracking rows as one backtracking-sweep call at half the budget."""
    calls, bt_calls = [], []
    sweep, bt_sweep = tdriver.resident_rule_sweep, tdriver.resident_bt_sweep

    def counting(*args, **kw):
        calls.append((args[3], args[5], kw))
        return sweep(*args, **kw)

    def bt_counting(*args, **kw):
        bt_calls.append((args[3], args[5], kw))
        return bt_sweep(*args, **kw)

    monkeypatch.setattr(tdriver, "resident_rule_sweep", counting)
    monkeypatch.setattr(tdriver, "resident_bt_sweep", bt_counting)
    tdriver.main(["--outdir", str(tmp_path), "--resident", "--datasets", "heart_scale",
                  "--maxit", "40", "--no-plot", "--device", "cpu"])
    assert len(calls) == 1 and len(bt_calls) == 1
    bt_rows, bt_maxit, bt_kw = bt_calls[0]
    assert bt_maxit == 20 and bt_kw["obj_kind"] == "logreg" and bt_kw["m_true"] == 270.0
    np.testing.assert_array_equal(bt_rows[:, 1:], [[1.0, 0], [1.5, 0], [2.0, 0], [1.0, 1]])
    rows, maxit, kw = calls[0]
    assert maxit == 400 and kw["obj_kind"] == "logreg" and kw["m_true"] == 270.0
    np.testing.assert_array_equal(rows[:, 1:], [[2, 0, 1e-8, 400], [0, 0, 1e-7, 40],
                                                [0, 1, 1e-7, 20], [1, 0, 1e-7, 40],
                                                [2, 0, 1e-7, 40]])


def test_driver_spectral_lf_and_refusals(tmp_path):
    x, _, _, _, _ = logreg_case()
    x1 = np.hstack([x, np.ones((60, 1))])
    assert tdriver.lipschitz_estimate(x, spectral=True) == pytest.approx(
        np.linalg.norm(x1, 2) ** 2 / 240, rel=1e-15)
    assert tdriver.lipschitz_estimate(x) >= tdriver.lipschitz_estimate(x, spectral=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdriver.main(["--outdir", str(tmp_path), "--datasets", "heart_scale", "--no-plot"])
