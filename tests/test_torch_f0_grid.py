"""K7b's and K7c's plain versions against the JAX package, on the same numpy inputs (f64 on
the CPU): the f = 0 dataset grids ``resident_mpls_grid`` and ``resident_adapdmp_grid`` (K7a's
two cores over every (dataset, t) cell) and ``resident_cv_grid`` (K7d's Condat-Vu over the
datasets) of ``adaprox_tpu_torch/ops/resident_f0.py``, and both f = 0 drivers'
``--resident-grid``.

The JAX side runs its kernels in interpret mode, as tests/test_kernels.py does; the port's
entries take their plain versions on CPU tensors. The CUDA kernels are tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py.

About the tolerances. On tests/test_kernels.py's grid problem (two datasets, (64, 128) and
(32, 128) zero-padded to 64 rows, lams [0.05, 0.1], ts [0.5, 2]) the plain grids agreed
with JAX's interpret-mode kernels to 1.3e-11 of norm_res (MP, l1, 300 iterations) and
4.1e-14 in x, with every trial count equal; Condat-Vu to 1.8e-15. So the rows are held to
rtol 1e-9 (norm_res 1e-8, x rtol 1e-8 / atol 1e-12), the counts, the trial counts and
ls_failed exactly, as tests/test_torch_f0_sweep.py holds K7a.
"""

import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of
from test_torch_pd import _close, t64

import adaprox_tpu_torch.utils.logging as tlog
from adaprox_tpu.experiments import least_absolute_deviation as jlad
from adaprox_tpu.experiments import square_root_lasso as jsl
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.experiments import least_absolute_deviation as tlad
from adaprox_tpu_torch.experiments import square_root_lasso as tsl
from adaprox_tpu_torch.ops import resident_f0 as tf

INNERS = ("l2", "l1")
TS = [0.5, 2.0]
LAMS = [0.05, 0.1]
GRIDS = {
    "mp": (jr.resident_mpls_grid, tf.resident_mpls_grid, tf.resident_mpls_grid_plain,
           tf.resident_mpls_sweep),
    "adapdmp": (jr.resident_adapdmp_grid, tf.resident_adapdmp_grid,
                tf.resident_adapdmp_grid_plain, tf.resident_adapdmp_sweep),
}


def grid_case():
    """tests/test_kernels.py's grid problem: two Gaussian datasets, (64, 128) and (32, 128),
    zero-padded to 64 rows. Returns (a_stack (2, 64, 128), bv_stack (2, 64), the p2s of
    each core: sigma0 1 for MP, each dataset's ||A||_F for AdaPDM+)."""
    rng = np.random.default_rng(11)
    a_stack, bv_stack, norms = np.zeros((2, 64, 128)), np.zeros((2, 64)), []
    for d, (m, n) in enumerate([(64, 128), (32, 128)]):
        a = rng.standard_normal((m, n)) / np.sqrt(m)
        a_stack[d, :m], bv_stack[d, :m] = a, rng.standard_normal(m)
        norms.append(float(np.linalg.norm(a)))
    return a_stack, bv_stack, {"mp": [1.0, 1.0], "adapdmp": norms}


def cv_steps(p2s):
    norms = p2s["adapdmp"]
    return [1.0 / na for na in norms], [0.99 / na for na in norms]


def _grids_match(got, want):
    assert got[1].dtype == torch.int32 and got[3].dtype == got[4].dtype == torch.bool
    for k in (1, 3, 4):  # numit, converged, ls_failed
        np.testing.assert_array_equal(np_of(got[k]), np_of(want[k]))
    np.testing.assert_array_equal(np_of(got[5][3]), np_of(want[5][3]))  # trials
    for k in (0, 1, 4):  # gamma, sigma, objective
        _close(got[5][k], want[5][k])
    _close(got[5][2], want[5][2], rtol=1e-8)
    _close(got[2], want[2], rtol=1e-8)
    _close(got[0], want[0], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("tol,maxit", [(0.0, 60), (1e-6, 300)])
@pytest.mark.parametrize("h_kind", INNERS)
@pytest.mark.parametrize("core", list(GRIDS))
def test_k7b_plain_matches_jax(core, h_kind, tol, maxit):
    """Every output of the (dataset x t) grid against JAX's interpret-mode K7b: numit, the
    trial counts, converged and ls_failed exactly, the histories, norm_res and x to the
    tolerances of the module docstring; at tol 0 and at JAX's own test's tol 1e-6."""
    a, bv, p2s = grid_case()
    jfn, fn, _, _ = GRIDS[core]
    want = jfn(jnp.asarray(a), jnp.asarray(bv), jnp.asarray(LAMS), jnp.asarray(TS),
               jnp.asarray(p2s[core]), tol, maxit, record=True, h_kind=h_kind, interpret=True)
    got = fn(t64(a), t64(bv), LAMS, TS, p2s[core], tol, maxit, record=True, h_kind=h_kind)
    assert tuple(got[0].shape) == (2, 2, 128) and got[1].shape == (2, 2)
    assert all(h.shape == (2, 2, maxit) for h in got[5])
    _grids_match(got, want)
    if core == "mp":  # the linesearch ran: some iteration took more than one trial
        assert int(got[5][3].max()) > 1


@pytest.mark.parametrize("h_kind", INNERS)
def test_k7c_plain_matches_jax(h_kind):
    """Condat-Vu over the two datasets against JAX's interpret-mode K7c: numit and converged
    exactly, norm_res, x and both histories to rtol 1e-9."""
    a, bv, p2s = grid_case()
    gammas, sigmas = cv_steps(p2s)
    want = jr.resident_cv_grid(jnp.asarray(a), jnp.asarray(bv), jnp.asarray(LAMS),
                               jnp.asarray(gammas), jnp.asarray(sigmas), 1e-6, 300,
                               h_kind=h_kind, interpret=True)
    got = tf.resident_cv_grid(t64(a), t64(bv), LAMS, gammas, sigmas, 1e-6, 300, h_kind=h_kind)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool
    assert tuple(got[0].shape) == (2, 128) and all(h.shape == (2, 300) for h in got[4])
    np.testing.assert_array_equal(np_of(got[1]), np_of(want[1]))
    np.testing.assert_array_equal(np_of(got[3]), np_of(want[3]))
    for u, w in zip(got[:3:2] + tuple(got[4]), want[:3:2] + tuple(want[4])):
        _close(u, w)


@pytest.mark.parametrize("core", list(GRIDS))
def test_k7b_cells_are_the_datasets_sweeps(core):
    """Each cell of the grid equals the port's own sweep on its dataset's slice with that
    dataset's lam and p2, exactly; each K7c row the K7d solve on its slice."""
    a, bv, p2s = grid_case()
    _, fn, _, sweep = GRIDS[core]
    for h_kind in INNERS:
        got = fn(t64(a), t64(bv), LAMS, TS, p2s[core], 1e-6, 200, record=True, h_kind=h_kind)
        for d in range(2):
            one = sweep(t64(a[d]), t64(bv[d]), LAMS[d], TS, p2s[core][d], 1e-6, 200,
                        record=True, h_kind=h_kind)
            for u, w in zip(got[:5] + tuple(got[5]), one[:5] + tuple(one[5])):
                assert torch.equal(u[d], w)
    gammas, sigmas = cv_steps(p2s)
    got = tf.resident_cv_grid(t64(a), t64(bv), LAMS, gammas, sigmas, 1e-6, 200)
    for d in range(2):
        one = tf.resident_condat_vu(t64(a[d]), t64(bv[d]), LAMS[d], gammas[d], sigmas[d], 1e-6,
                                    200, record=True)
        for u, w in zip(got[:4] + tuple(got[4]), one[:4] + tuple(one[4])):
            assert torch.equal(u[d], w)


def test_grid_first_dataset_breaking_down_leaves_the_second_alone():
    """A grid whose first dataset breaks down (an infinite entry of bv: NaN from the first
    dual step, every solve stops after one iteration with x and norm_res NaN; AdaPDM+
    exhausts its 101 trials) gives the second dataset's cells the bits that a grid whose
    first dataset converges gives them."""
    a, bv, p2s = grid_case()
    broken = bv.copy()
    broken[0, 0] = np.inf
    gammas, sigmas = cv_steps(p2s)
    for h_kind in INNERS:
        for core, (_, fn, _, _) in GRIDS.items():
            bad, good = (fn(t64(a), t64(b), LAMS, TS, p2s[core], 1e-6, 100, record=True,
                            h_kind=h_kind) for b in (broken, bv))
            assert bad[1][0].tolist() == [1, 1] and bool(torch.isnan(bad[2][0]).all())
            assert bool(torch.isnan(bad[0][0]).all()) and bool(bad[4][0].all()) == (
                core == "adapdmp")
            for u, w in zip(bad[:5] + tuple(bad[5]), good[:5] + tuple(good[5])):
                assert torch.equal(u[1], w[1])
        bad, good = (tf.resident_cv_grid(t64(a), t64(b), LAMS, gammas, sigmas, 1e-6, 100,
                                         h_kind=h_kind) for b in (broken, bv))
        assert int(bad[1][0]) == 1 and bool(torch.isnan(bad[2][0]))
        for u, w in zip(bad[:4] + tuple(bad[4]), good[:4] + tuple(good[4])):
            assert torch.equal(u[1], w[1])


def _own_and_common():
    """A housing-like 100 x 13 problem (lam 1) padded to its own 128 x 128 and, beside a
    200 x 13 one, to the grid's common 256 x 128."""
    def case(m, seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal((m, 13))
        return a, a @ (rng.standard_normal(13) * (rng.random(13) < 0.2)) + 0.1 * \
            rng.standard_normal(m)

    (a0, b0), (a1, b1) = case(100, 2), case(200, 3)
    a_stack, bv_stack = np.zeros((2, 256, 128)), np.zeros((2, 256))
    a_stack[0, :100, :13], bv_stack[0, :100] = a0, b0
    a_stack[1, :200, :13], bv_stack[1, :200] = a1, b1
    own, own_b = np.zeros((128, 128)), np.zeros(128)
    own[:100, :13], own_b[:100] = a0, b0
    return a_stack, bv_stack, own, own_b, [float(np.linalg.norm(a0)), float(np.linalg.norm(a1))]


# Common padding against a dataset's own 128-padding, f64 on the CPU (measured): on this
# case every history row of both cores and of Condat-Vu agreed to the last bit over every
# iteration (l2 at tol 1e-6: converged at 78-446 iterations; l1 at tol 1e-6 over all 5000,
# AdaPDM+ converged at 3422 and 4579), and so did the final objectives: the padded rows add
# exact zeros to every sum. Held: l2 to convergence and l1 over 300 iterations, numit and
# converged equal, the rows and the final objective within rtol 1e-9.
PAD_HORIZON = {"l2": (1e-6, 5000), "l1": (0.0, 300)}


@pytest.mark.parametrize("h_kind", INNERS)
def test_common_padding_matches_each_datasets_own(h_kind):
    a_stack, bv_stack, own, own_b, norms = _own_and_common()
    tol, maxit = PAD_HORIZON[h_kind]
    for core, (_, fn, _, sweep) in GRIDS.items():
        p2 = [1.0, 1.0] if core == "mp" else norms
        got = fn(t64(a_stack), t64(bv_stack), [1.0, 1.0], [0.5, 1.0, 2.0], p2, tol, maxit,
                 record=True, h_kind=h_kind)
        want = sweep(t64(own), t64(own_b), 1.0, [0.5, 1.0, 2.0], p2[0], tol, maxit, record=True,
                     h_kind=h_kind)
        assert got[1][0].tolist() == want[1].tolist() and torch.equal(got[3][0], want[3])
        if h_kind == "l2":
            assert bool(want[3].all())
        for i, k in enumerate(want[1].tolist()):
            for u, w in zip(got[5], want[5]):
                _close(u[0, i, :k], w[i, :k])
            _close(got[5][4][0, i, k - 1], want[5][4][i, k - 1])
        assert not bool(got[0][0, :, 13:].any())
        _close(got[0][0, :, :13], want[0][:, :13], rtol=1e-9, atol=1e-12)
    gammas, sigmas = [1 / na for na in norms], [0.99 / na for na in norms]
    got = tf.resident_cv_grid(t64(a_stack), t64(bv_stack), [1.0, 1.0], gammas, sigmas, tol,
                              maxit, h_kind=h_kind)
    want = tf.resident_condat_vu(t64(own), t64(own_b), 1.0, gammas[0], sigmas[0], tol, maxit,
                                 record=True, h_kind=h_kind)
    k = int(want[1])
    assert int(got[1][0]) == k and bool(got[3][0]) == bool(want[3])
    for u, w in zip(got[4], want[4]):
        _close(u[0, :k], w[:k])


@pytest.mark.parametrize("core", list(GRIDS))
def test_k7b_zero_iterations_match_jax(core):
    """maxit 0: JAX's zero-iteration grid (x0 or x1 = 0, numit 0, norm_res inf, not
    converged, no linesearch failure); with records, empty (D, T, 0) histories. K7c at
    maxit 0 returns the warm-up's x, numit 0 and empty (D, 0) histories (JAX's interpret
    mode cannot record at maxit 0: its history block has length 0)."""
    a, bv, p2s = grid_case()
    jfn, fn, _, _ = GRIDS[core]
    want = jfn(jnp.asarray(a), jnp.asarray(bv), jnp.asarray(LAMS), jnp.asarray(TS),
               jnp.asarray(p2s[core]), 0.0, 0, h_kind="l2", interpret=True)
    for record in (False, True):
        got = fn(t64(a), t64(bv), LAMS, TS, p2s[core], 0.0, 0, record=record)
        assert got[1].tolist() == np_of(want[1]).tolist() == [[0, 0], [0, 0]]
        assert np.isinf(np_of(got[2])).all() and np.isinf(np_of(want[2])).all()
        assert not bool(got[3].any()) and not bool(got[4].any())
        _close(got[0], want[0], rtol=0, atol=0)
        assert len(got) == (6 if record else 5)
    assert all(h.shape == (2, 2, 0) for h in got[5])
    gammas, sigmas = cv_steps(p2s)
    x, numit, nres, conv, hists = tf.resident_cv_grid(t64(a), t64(bv), LAMS, gammas, sigmas,
                                                      0.0, 0)
    assert numit.tolist() == [0, 0] and bool(torch.isinf(nres).all()) and not bool(conv.any())
    assert not bool(x.any()) and all(h.shape == (2, 0) for h in hists)


def _entry_calls():
    """(call, step table names) for each grid entry and plain version; call(a_stack,
    bv_stack, lams=, steps=, ts=, h_kind=, maxit=) fills in valid values for the rest."""
    calls = []
    for core, (_, fn, plain, _) in GRIDS.items():
        for entry in (fn, plain):
            def call(a, bv, lams=(1.0, 1.0), steps=((1.0, 1.0),), ts=TS, h_kind="l2", maxit=5,
                     entry=entry):
                return entry(a, bv, list(lams), ts, list(steps[0]), 1e-5, maxit, h_kind=h_kind)
            calls.append((call, ("sigma0s",) if core == "mp" else ("eta0s",)))
    for entry in (tf.resident_cv_grid, tf.resident_cv_grid_plain):
        def call(a, bv, lams=(1.0, 1.0), steps=((1.0, 1.0), (1.0, 1.0)), ts=None, h_kind="l2",
                 maxit=5, entry=entry):
            return entry(a, bv, list(lams), list(steps[0]), list(steps[1]), 1e-5, maxit,
                         h_kind=h_kind)
        calls.append((call, ("gammas", "sigmas")))
    return calls


def test_grid_entries_validate_before_running(monkeypatch):
    """Every refusal comes before any compute, on the three entries and their plain
    versions: a_stack not 3-D or empty, bv_stack not (D, m), a per-dataset table not (D,),
    not real, not finite, or (the steps) not positive, a non-positive or non-finite t,
    h_kind, maxit, and a device that is neither CPU nor CUDA."""
    def boom(*args, **kw):
        raise AssertionError("a solve ran")

    for name in ("_mpls_core_plain", "_adapdmp_core_plain", "resident_condat_vu_plain"):
        monkeypatch.setattr(tf, name, boom)
    a = torch.zeros((2, 128, 64), dtype=torch.float64)
    bv = torch.zeros((2, 128), dtype=torch.float64)
    for call, names in _entry_calls():
        good = ((1.0, 1.0),) * len(names)
        for shapes in ((a[0], bv), (a, bv[:, :64]), (a, bv[0])):
            with pytest.raises(ValueError, match="need a_stack"):
                call(*shapes)
        with pytest.raises(ValueError, match="need a_stack"):
            call(a[:0], bv[:0], lams=(), steps=((),) * len(names))
        with pytest.raises(ValueError, match="lams must hold one value a dataset"):
            call(a, bv, lams=(1.0,))
        with pytest.raises(ValueError, match="every entry of lams must be finite"):
            call(a, bv, lams=(1.0, float("nan")))
        with pytest.raises(TypeError, match="lams must be real numbers"):
            call(a, bv, lams=(True, False))
        for j, name in enumerate(names):
            for bad in ((1.0, 0.0), (1.0, -2.0), (float("inf"), 1.0), (float("nan"), 1.0)):
                steps = good[:j] + (bad,) + good[j + 1:]
                with pytest.raises(ValueError, match=f"every entry of {name} must be positive"):
                    call(a, bv, steps=steps)
            with pytest.raises(ValueError, match=f"{name} must hold one value a dataset"):
                call(a, bv, steps=good[:j] + ((1.0, 1.0, 1.0),) + good[j + 1:])
        if names[0] != "gammas":
            for ts in ([1.0, 0.0], [-0.5], [float("nan")], [float("inf")]):
                with pytest.raises(ValueError, match="coupling t must be positive"):
                    call(a, bv, ts=ts)
            for ts in ([], [[0.5, 1.0]]):
                with pytest.raises(ValueError, match="one dimension"):
                    call(a, bv, ts=ts)
        with pytest.raises(ValueError, match="h_kind"):
            call(a, bv, h_kind="linf")
        with pytest.raises(ValueError, match="maxit"):
            call(a, bv, maxit=-1)
    for fn in (tf.resident_mpls_grid, tf.resident_adapdmp_grid):
        with pytest.raises(ValueError, match="CPU .plain version. or CUDA"):
            fn(a.to("meta"), bv.to("meta"), [1.0, 1.0], TS, [1.0, 1.0], 1e-5, 5)
    with pytest.raises(ValueError, match="CPU .plain version. or CUDA"):
        tf.resident_cv_grid(a.to("meta"), bv.to("meta"), [1.0, 1.0], [1.0, 1.0], [1.0, 1.0],
                            1e-5, 5)


# -- the drivers' --resident-grid ------------------------------------------------------------


@pytest.fixture
def no_download(monkeypatch):
    """The JAX loader's download fails as it does without a network."""
    def refuse(*args, **kw):
        raise urllib.error.URLError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


DRIVER_NAMES = (["Condat-Vu"] + [f"Malitsky-Pock (t={t})" for t in tsl.T_VALUES]
                + [f"AdaPDM+ (t={t})" for t in tsl.T_VALUES])
GRID_DATASETS = ("housing_scale", "abalone")
# JAX's --resident-grid against the port's at --maxit 40, f64 (measured): every counter
# equal and norm_res within rel 2.4e-11 over all 40 iterations (the square-root lasso on
# abalone; LAD within 5.9e-13), every row of both datasets and both drivers. Held: the
# counters exactly, norm_res to rel 1e-9 over the 40.
GRID_MAXIT = 40


@pytest.mark.parametrize("jmod,tmod", [(jsl, tsl), (jlad, tlad)], ids=["sqrt_lasso", "lad"])
def test_driver_resident_grid_matches_jax(tmp_path, capsys, no_download, jmod, tmod):
    """--resident-grid on housing_scale's and abalone's stand-ins (common padding 4224 x 128)
    against the JAX driver's --resident-grid --cpu --f64: each file's 31 rows in JAX's order
    and names, KEYS, the counters row by row exactly and norm_res to rel 1e-9 over all
    GRID_MAXIT iterations; the meta rows' keys, fast_path "resident-grid", fast_methods and
    the wall keys."""
    args = ["--datasets", ",".join(GRID_DATASETS), "--maxit", str(GRID_MAXIT), "--no-plot",
            "--resident-grid"]
    jmod.main(["--cpu", "--f64", "--outdir", str(tmp_path / "jax"), *args])
    tmod.main(["--outdir", str(tmp_path / "torch"), "--device", "cpu", *args])
    assert "(grid-batched)" in capsys.readouterr().out
    for name in GRID_DATASETS:
        jrows, trows = (tlog.read_jsonl(tmp_path / side / f"{name}.jsonl")
                        for side in ("jax", "torch"))
        jby, tby = {}, {}
        for rows, by in ((jrows, jby), (trows, tby)):
            for r in rows:
                if "norm_res" in r:
                    by.setdefault(r["method"], []).append(r)
        assert list(tby) == list(jby) == DRIVER_NAMES
        for method in DRIVER_NAMES:
            for rt, rj in zip(tby[method], jby[method], strict=True):
                assert list(rt) == tsl.KEYS
                assert (rt["method"], rt["A_evals"], rt["At_evals"]) == (
                    rj["method"], rj["A_evals"], rj["At_evals"]), method
                assert rt["norm_res"] == pytest.approx(rj["norm_res"], rel=1e-9), method
            assert len(tby[method]) == GRID_MAXIT, method
        tmeta = [r for r in trows if "norm_res" not in r]
        jmeta = [r for r in jrows if "norm_res" not in r]
        assert [list(r) for r in tmeta] == [list(r) for r in jmeta] == [
            ["wall_s", "fast_path", "grid_total_s", "fast_methods"], ["data_source"]]
        assert tmeta[0]["fast_path"] == jmeta[0]["fast_path"] == "resident-grid"
        assert tmeta[0]["fast_methods"] == jmeta[0]["fast_methods"] == tsl.FAST_METHODS
        for key in ("wall_s", "grid_total_s"):
            assert list(tmeta[0][key]) == list(jmeta[0][key]) == tsl.FAST_METHODS
        # each file's share of the totals, both rounded to 4 places
        total = tmeta[0]["grid_total_s"]
        assert all(abs(tmeta[0]["wall_s"][k] - v / len(GRID_DATASETS)) <= 1e-4
                   for k, v in total.items())
        assert tmeta[1] == jmeta[1] == {"data_source": "synthetic"}


def test_driver_resident_grid_routing_limit_raises(tmp_path, monkeypatch):
    """Past the routing limit (24 MiB a padded layout, the JAX driver's) --resident-grid
    raises before anything runs, as the JAX driver does: there is no fallback."""
    monkeypatch.setattr(tsl, "_VMEM_BYTES", 1024)
    with pytest.raises(ValueError, match=r"common padded shape \(512, 128\) exceeds"):
        tsl.main(["--outdir", str(tmp_path), "--device", "cpu", "--datasets", "housing_scale",
                  "--maxit", "3", "--no-plot", "--resident-grid"])
    assert not (tmp_path / "housing_scale.jsonl").exists()


def test_grid_inputs_stack_the_drivers_padding():
    """``grid_inputs`` stacks [X 1] and y as the JAX driver does: the common shape is the
    largest 128-multiples, each slice is the dataset's own --resident input zero-padded
    further, norm_as the unpadded Frobenius norms."""
    from adaprox_tpu_torch.convert import sqrt_lasso_from_numpy

    names, a_stack, bv_stack, norms, sources = tsl.grid_inputs(
        ["housing_scale", "abalone"], device="cpu", dtype=torch.float64)
    assert names == ["housing_scale", "abalone"] and sources == ["synthetic"] * 2
    assert tuple(a_stack.shape) == (2, 4224, 128) and tuple(bv_stack.shape) == (2, 4224)
    for d, name in enumerate(names):
        x, y, _ = tsl.load(name)
        _, _, h, a_op, norm_a = sqrt_lasso_from_numpy(x, y, 10.0, "l2", device="cpu",
                                                      dtype=torch.float64)
        a_own, bv_own = tsl.resident_inputs(a_op.a, -h.b)
        m, n = a_own.shape
        assert norms[d] == norm_a
        assert torch.equal(a_stack[d, :m, :n], a_own) and not bool(a_stack[d, m:].any())
        assert not bool(a_stack[d, :, n:].any())
        assert torch.equal(bv_stack[d, :m], bv_own) and not bool(bv_stack[d, m:].any())
