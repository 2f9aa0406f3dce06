"""aGRAAL in the PyTorch port against the JAX package, on the same numpy inputs
(f64 on the CPU unless stated): the numpy copy of JAX's normal draw
(``utils/jax_random.py``), the engine solver ``agraal`` and K4's aGRAAL core
``resident_agraal`` through its plain version, with its records.

The JAX side runs its Pallas kernel in interpret mode, as tests/test_kernels.py
does; the port's wrapper takes its plain version on CPU tensors. The CUDA kernel
is tested on the card (tests/test_torch_cuda.py) and by chip_smoke.py. The
drivers' aGRAAL rows are held to JAX's in the driver tests of
test_torch_lasso.py, test_torch_backtracking.py, test_torch_logreg.py and
test_torch_cubic.py.

About the horizons. aGRAAL's step-size recurrence amplifies summation-order
differences as AdaPGM's does (ROADMAP, "Trajectory parity has a horizon").
Measured on the CPU in f64 over 300 iterations, tol 0, the first step size,
residual or objective past rtol 1e-9 came at (gamma0 given / secant): the
engine on the lasso 85 / 58, the logistic problem 53 / 64, the cubic model
54 / 28; the kernel's plain version against JAX's interpret-mode kernel on the
lasso 85 / 58, the padded logistic problem 76 / 49, the padded cubic model
40 / 28. The rows are held to rtol 1e-9 over about two thirds of those. Solved
to tol, the two sides stop up to 7% of the iterations apart (the lasso at tol
1e-6: 1552 against 1543 iterations, gamma0 given), so there the tests hold the
solution and the counters' form, and the cubic model, which stops at the same
iteration at tol 1e-4 on both sides, the counters exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
from adaprox_tpu.models.objectives import Cubic as JCubic
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.models.objectives import LogisticLoss as JLogisticLoss
from adaprox_tpu.models.synthetic import random_lasso
from adaprox_tpu.ops import resident_bt as jrb
from adaprox_tpu_torch.ops import resident_bt as trb
from adaprox_tpu_torch.utils import jax_random as tjr

F64 = torch.float64
HIST = ("gamma", "norm_res", "objective")
COUNTERS = ("f_evals", "grad_f_evals", "prox_g_evals", "prox_h_evals", "A_evals", "At_evals")

# -- the PRNG --------------------------------------------------------------------------------

SEEDS = [0, 1, 42, 2**32 + 5]


def test_jax_threefry_is_partitionable():
    """The copy draws in the partitionable layout (one hash a flat index); a
    JAX that changed this default would draw other numbers."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(tjr.prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bits", [32, 64])
def test_random_bits_match_jax(bits, seed):
    dtype = jnp.uint32 if bits == 32 else jnp.uint64
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (3, 77), dtype))
    np.testing.assert_array_equal(tjr.random_bits(seed, bits, (3, 77)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 128, 1000, 4097])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_uniform_is_bit_exact(dtype, n, seed):
    """The uniform bits equal jax.random.uniform's, on [0, 1) and on the
    normal's [nextafter(-1, 0), 1)."""
    key = jax.random.PRNGKey(seed)
    lo = np.nextafter(np.array(-1.0, dtype), np.array(0.0, dtype), dtype=dtype)
    for lims in ((0.0, 1.0), (lo, 1.0)):
        want = np.asarray(jax.random.uniform(key, (n,), dtype, *lims))
        got = tjr.uniform(seed, (n,), dtype, *lims)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _ulps(got, want):
    ints = np.int32 if got.dtype == np.float32 else np.int64
    return np.abs(got.view(ints).astype(np.int64) - want.view(ints).astype(np.int64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_within_ulps(dtype):
    """100000 draws: at most 4 ulps from jax.random.normal's and at least 90%
    bit for bit (measured: 3 ulps and 95.5% in float32, 3 ulps and 92.7% in
    float64, where XLA's compiled log1p and polynomial round otherwise than
    numpy in a few last bits)."""
    for seed in (0, 2**32 + 5):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (100000,), dtype))
        got = tjr.normal(seed, (100000,), dtype)
        assert got.dtype == want.dtype and np.isfinite(got).all()
        ulps = _ulps(got, want)
        assert ulps.max() <= 4 and (ulps == 0).mean() >= 0.9, (ulps.max(), (ulps == 0).mean())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_normal_of_a_shape(dtype):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (13, 9), dtype))
    got = tjr.normal(7, (13, 9), dtype)
    assert got.shape == (13, 9) and _ulps(got, want).max() <= 4


def test_normal_refuses_what_it_does_not_copy():
    with pytest.raises(TypeError, match="float32 and float64"):
        tjr.normal(0, (4,), np.float16)
    with pytest.raises(ValueError, match="seed"):
        tjr.normal(-1, (4,))


# -- the engine ------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _problems():
    """The lasso (JAX's own resident case, l1 1), the logistic loss on 60
    sparse rows of 13 features (l1 0.01) and a PSD 14x14 cubic model (c 1,
    zero prox), each with gamma0 = 1/L."""
    prob = random_lasso(m=64, n=128, pfactor=8, seed=3)
    x = gaussian(11, 60, 13) * (gaussian(12, 60, 13) > 0.5)
    y = (x @ gaussian(13, 13) + 0.3 * gaussian(14, 60) > 0).astype(float)
    g = gaussian(21, 40, 14) / np.sqrt(40)
    h, q = g.T @ g, gaussian(22, 14) / 14
    x1 = np.hstack([x, np.ones((60, 1))])
    return {"ls": (prob.a, prob.b, 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)),
            "logreg": (x, y, 4 * 60 / float(np.linalg.norm(x1, 2) ** 2)),
            "cubic": (h, q, 1.0 / float(np.linalg.norm(h, 2)))}


def _engine_case(side, kind):
    """(f, g, n, gamma0) on ``side``."""
    a, b, gam = _problems()[kind]
    if side == "jax":
        if kind == "ls":
            return (JLS(a=jnp.asarray(a), b=jnp.asarray(b)), ap.L1Norm(lam=jnp.float64(1.0)),
                    128, gam)
        if kind == "logreg":
            return (JLogisticLoss(x=jnp.asarray(a), y=jnp.asarray(b)),
                    ap.L1Norm(lam=jnp.float64(0.01)), 14, gam)
        return (JCubic(q_mat=jnp.asarray(a), q_vec=jnp.asarray(b), c=jnp.asarray(1.0)), ap.Zero(),
                14, gam)
    if kind == "ls":
        return (*apt.lasso_from_numpy(a, b, 1.0, device="cpu", dtype=F64, fused=False), 128, gam)
    if kind == "logreg":
        return (*apt.logreg_from_numpy(a, b, 0.01, device="cpu", dtype=F64, fused=False), 14, gam)
    return apt.cubic_from_numpy(a, b, 1.0, device="cpu", dtype=F64), apt.Zero(), 14, gam


def _engine(side, kind, *, x0="given", gamma0="given", **kw):
    """aGRAAL from x1 = 0: ``x0`` "given" passes the numpy copy's draw to both
    sides, "drawn" lets each solver draw its own; ``gamma0`` "given" passes
    1/L, "secant" nothing."""
    f, g, n, gam = _engine_case(side, kind)
    if gamma0 == "given":
        kw["gamma0"] = gam
    if x0 == "given":
        xc = tjr.normal(0, (n,), np.float64)
        kw["x0"] = jnp.asarray(xc) if side == "jax" else torch.from_numpy(xc)
    if side == "jax":
        return ap.agraal(jnp.zeros(n), f=f, g=g, **kw)
    return apt.agraal(torch.zeros(n, dtype=F64), f=f, g=g, **kw)


# two thirds of the measured horizons (module docstring)
ENGINE_HORIZON = {("ls", "given"): 56, ("ls", "secant"): 38, ("logreg", "given"): 35,
                  ("logreg", "secant"): 42, ("cubic", "given"): 36, ("cubic", "secant"): 18}


def _records_match(rt, rj, n_rows):
    valid = np_of(rj.records.valid).astype(bool)
    assert len(rt.records.it) == valid.sum() == rt.numit == int(rj.numit) == n_rows
    for k in ("gamma", "sigma", "norm_res", "objective"):
        np.testing.assert_allclose(np_of(getattr(rt.records, k)),
                                   np_of(getattr(rj.records, k))[valid], rtol=1e-9, err_msg=k)
    for k in ("it",) + COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(rt.records, k)),
                                      np_of(getattr(rj.records, k))[valid], err_msg=k)
    assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)


@pytest.mark.parametrize("gamma0", ["given", "secant"])
@pytest.mark.parametrize("x0", ["given", "drawn"])
@pytest.mark.parametrize("kind", ["ls", "logreg", "cubic"])
def test_engine_rows_match_jax(kind, x0, gamma0):
    """Records, counters and the final point, tol 0, over the horizon; the
    drawn companion point comes from jax.random on one side and from the
    numpy copy on the other."""
    maxit = ENGINE_HORIZON[kind, gamma0]
    rj = _engine("jax", kind, x0=x0, gamma0=gamma0, tol=0.0, maxit=maxit, history=True)
    rt = _engine("torch", kind, x0=x0, gamma0=gamma0, tol=0.0, maxit=maxit, history=True)
    _records_match(rt, rj, maxit)
    assert rt.counters == (maxit + 2, maxit + 2, maxit, 0, 0, 0)
    np.testing.assert_allclose(np_of(rt.x), np_of(rj.x), rtol=1e-9, atol=1e-12)
    assert rt.name == "aGRAAL" and rt.x.dtype == F64


@pytest.mark.parametrize("kind", ["ls", "logreg", "cubic"])
def test_engine_converges_like_jax(kind):
    """Solved to tol (the cubic model 1e-4, where both sides stop at the same
    iteration; the others 1e-6, where they stop up to 7% apart): the same
    solution, and the at-check counters of a converged solve (the last
    gradient is not counted)."""
    tol = 1e-4 if kind == "cubic" else 1e-6
    rj = _engine("jax", kind, tol=tol, maxit=5000)
    rt = _engine("torch", kind, tol=tol, maxit=5000)
    assert float(rt.norm_res) <= tol and float(rj.norm_res) <= tol
    assert abs(rt.numit - int(rj.numit)) <= 0.07 * int(rj.numit)
    assert rt.counters == (rt.numit + 1, rt.numit + 1, rt.numit, 0, 0, 0)
    if kind == "cubic":
        assert rt.numit == int(rj.numit)
        assert tuple(rt.counters) == tuple(int(c) for c in rj.counters)
    xj = np_of(rj.x)
    np.testing.assert_allclose(np_of(rt.x), xj, atol=1e-4 * float(np.abs(xj).max()))
    f, g, _, _ = _engine_case("torch", kind)
    fj, gj, _, _ = _engine_case("jax", kind)
    assert float(f.value(rt.x) + g(rt.x)) == pytest.approx(float(fj.value(rj.x) + gj(rj.x)),
                                                           rel=1e-9)


def test_engine_history_off_is_the_same_solve():
    on = _engine("torch", "ls", tol=1e-6, maxit=3000, history=True)
    off = _engine("torch", "ls", tol=1e-6, maxit=3000)
    assert off.records is None and off.numit == on.numit and off.counters == on.counters
    assert torch.equal(off.x, on.x)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_engine_identical_iterates_take_the_growth_bound(side):
    """x0 = x1: the first curvature ratio is 0/0 = NaN, taken as +inf, so the
    step grows by rho (as in JAX; the port's rows are held to JAX's)."""
    f, g, n, gam = _engine_case(side, "ls")
    if side == "jax":
        res = ap.agraal(jnp.zeros(n), f=f, g=g, x0=jnp.zeros(n), gamma0=gam, tol=0.0, maxit=5,
                        history=True)
    else:
        res = apt.agraal(torch.zeros(n, dtype=F64), f=f, g=g, x0=torch.zeros(n, dtype=F64),
                         gamma0=gam, tol=0.0, maxit=5, history=True)
    rho = 1 / 1.5 + 1 / 1.5**2
    assert float(res.records.gamma[0]) == pytest.approx(rho * gam, rel=1e-12)
    assert np.isfinite(np_of(res.records.gamma)).all()


@pytest.mark.parametrize("opt", ["resume_state", "scalar_dtype", "it_cap"])
def test_engine_refuses_what_is_not_ported(opt):
    f, g, n, gam = _engine_case("torch", "ls")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        apt.agraal(torch.zeros(n, dtype=F64), f=f, g=g, gamma0=gam, **{opt: 1})
    with pytest.raises(TypeError, match="torch.Tensor"):
        apt.agraal(np.zeros(n), f=f, g=g, gamma0=gam)


# -- K4's aGRAAL core, the plain version -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_case(obj):
    """(a, b, n_true, gamma0, kwargs) of a kernel case at 64x128: the lasso,
    the logistic [X 1] zero-padded from 60x14 (m_true 60) and the cubic model
    zero-padded from 14 to 128."""
    a, b, gam = _problems()[obj]
    if obj == "ls":
        return a, b, 128, gam, dict(prox_kind="l1", p1=1.0)
    if obj == "logreg":
        ap_, bp = np.zeros((64, 128)), np.zeros(64)
        ap_[:60, :14], bp[:60] = np.hstack([a, np.ones((60, 1))]), b
        return ap_, bp, 14, gam, dict(prox_kind="l1", p1=0.01, obj_kind="logreg", m_true=60.0)
    hp, qp = np.zeros((128, 128)), np.zeros(128)
    hp[:14, :14], qp[:14] = a, b
    return hp, qp, 14, gam, dict(prox_kind="zero", obj_kind="cubic", cube_c=1.0)


def _companion(n, n_true):
    xc = np.zeros(n)
    xc[:n_true] = tjr.normal(0, (n_true,), np.float64)
    return xc


def _both(obj, gamma0, tol, maxit, **kw):
    a, b, n_true, gam, kcase = _kernel_case(obj)
    n = a.shape[1]
    xc = _companion(n, n_true)
    g0 = gam if gamma0 == "given" else 0.0
    oj = jrb.resident_agraal(jnp.asarray(a), jnp.asarray(b), jnp.zeros(n), jnp.asarray(xc), g0,
                             tol, maxit, interpret=True, **kcase, **kw)
    ot = trb.resident_agraal(torch.from_numpy(a), torch.from_numpy(b), torch.zeros(n, dtype=F64),
                             torch.from_numpy(xc), g0, tol, maxit, **kcase, **kw)
    return ot, oj, n_true


KERNEL_HORIZON = {("ls", "given"): 56, ("ls", "secant"): 38, ("logreg", "given"): 50,
                  ("logreg", "secant"): 32, ("cubic", "given"): 26, ("cubic", "secant"): 18}


@pytest.mark.parametrize("gamma0", ["given", "secant"])
@pytest.mark.parametrize("obj", ["ls", "logreg", "cubic"])
def test_kernel_plain_matches_jax(obj, gamma0):
    """resident_agraal against JAX's interpret-mode kernel, tol 0, over the
    horizon: the three histories, the stats and x; the padded coordinates
    stay exactly 0."""
    maxit = KERNEL_HORIZON[obj, gamma0]
    ot, oj, n_true = _both(obj, gamma0, 0.0, maxit, record=True)
    assert len(ot) == len(oj) == 7 and int(ot[1]) == int(oj[1]) == maxit
    assert bool(ot[3]) == bool(oj[3]) is False
    np.testing.assert_allclose(float(ot[2]), float(oj[2]), rtol=1e-6)  # f32 stats, as JAX's
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=1e-9, atol=1e-12)
    for k, name in enumerate(HIST):
        assert ot[4 + k].shape == (maxit,)
        np.testing.assert_allclose(np_of(ot[4 + k]), np_of(oj[4 + k]), rtol=1e-9, err_msg=name)
    assert not bool(ot[0][n_true:].any())


def test_kernel_plain_converged_matches_jax():
    """The cubic model solved to tol 1e-4 (both stop at iteration 90, past the
    horizon: norm_res there agrees to 2e-6), no records: numit, converged and
    x."""
    ot, oj, _ = _both("cubic", "given", 1e-4, 3000)
    assert len(ot) == len(oj) == 4
    assert int(ot[1]) == int(oj[1]) < 3000 and bool(ot[3]) and bool(oj[3])
    assert ot[2].dtype == F64 and float(ot[2]) == pytest.approx(float(oj[2]), rel=1e-4)
    np.testing.assert_allclose(np_of(ot[0]), np_of(oj[0]), rtol=1e-7, atol=1e-9)


def test_kernel_records_match_jax():
    """resident_agraal_records against JAX's on a solve that stops before
    maxit (rows past numit masked out)."""
    ot, _, _ = _both("cubic", "given", 1e-4, 120, record=True)
    numit = int(ot[1])
    rt = apt.resident_agraal_records(ot[1], *ot[4:7], maxit=120)
    rj = jrb.resident_agraal_records(numit, *(np_of(h) for h in ot[4:7]), maxit=120)
    for k in rt._fields:
        np.testing.assert_array_equal(np_of(getattr(rt, k)), np.asarray(getattr(rj, k)), k)
    assert int(rt.valid.sum()) == numit < 120
    assert not np_of(ot[4])[numit:].any()


@pytest.mark.parametrize("gamma0", ["given", "secant"])
def test_kernel_records_match_the_engine(gamma0):
    """The records of the plain kernel equal the engine's on the same
    companion point and gamma0, counters and all (the lasso, tol 0)."""
    maxit = KERNEL_HORIZON["ls", gamma0]
    res = _engine("torch", "ls", gamma0=gamma0, tol=0.0, maxit=maxit, history=True)
    ot, _, _ = _both("ls", gamma0, 0.0, maxit, record=True)
    recs = apt.resident_agraal_records(ot[1], *ot[4:7], maxit=maxit)
    for k in ("gamma", "norm_res", "objective"):
        np.testing.assert_allclose(np_of(getattr(recs, k)), np_of(getattr(res.records, k)),
                                   rtol=1e-9)
    for k in COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(recs, k)), np_of(getattr(res.records, k)), k)
    np.testing.assert_allclose(np_of(ot[0]), np_of(res.x), rtol=1e-9, atol=1e-12)


def test_kernel_identical_iterates_match_jax():
    """x0 = x1 and gamma0 given: the first curvature ratio is 0/0, taken as
    +inf; the rows equal JAX's. With gamma0 <= 0 the secant step is then NaN,
    which stops the solve after one iteration on both sides."""
    a, b, _, gam, kw = _kernel_case("ls")
    aj, bj, at, bt = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    for g0, maxit in ((gam, 10), (0.0, 10)):
        oj = jrb.resident_agraal(aj, bj, jnp.zeros(128), jnp.zeros(128), g0, 0.0, maxit,
                                 record=True, interpret=True, **kw)
        ot = trb.resident_agraal(at, bt, torch.zeros(128, dtype=F64), torch.zeros(128, dtype=F64),
                                 g0, 0.0, maxit, record=True, **kw)
        assert int(ot[1]) == int(oj[1])
        for k in range(3):
            np.testing.assert_allclose(np_of(ot[4 + k]), np_of(oj[4 + k]), rtol=1e-9)


def test_kernel_zero_iterations_return_x1():
    a, b, _, gam, kw = _kernel_case("ls")
    x1 = torch.from_numpy(gaussian(3, 128))
    x0 = x1 + torch.from_numpy(gaussian(4, 128))
    ot = trb.resident_agraal(torch.from_numpy(a), torch.from_numpy(b), x1, x0, gam, 0.0, 0,
                             record=True, **kw)
    assert int(ot[1]) == 0 and torch.equal(ot[0], x1) and not bool(ot[3])
    assert float(ot[2]) == float("inf") and all(h.shape == (0,) for h in ot[4:])


@pytest.mark.parametrize("kw,exc", [
    (dict(obj_kind="huber"), ValueError), (dict(prox_kind="nuclear"), ValueError),
    (dict(obj_kind="cubic"), ValueError), (dict(maxit=-1), ValueError),
    (dict(x0_len=127), ValueError),
])
def test_kernel_refuses_what_it_does_not_take(kw, exc):
    a = torch.from_numpy(_kernel_case("ls")[0])
    b = torch.from_numpy(_kernel_case("ls")[1])
    kw = dict(kw)
    maxit, x0_len = kw.pop("maxit", 5), kw.pop("x0_len", 128)
    with pytest.raises(exc):
        trb.resident_agraal(a, b, torch.zeros(128, dtype=F64), torch.zeros(x0_len, dtype=F64),
                            0.1, 0.0, maxit, **kw)
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        trb.resident_agraal(a.to("meta"), b.to("meta"), torch.zeros(128, device="meta"),
                            torch.zeros(128, device="meta"), 0.1, 0.0, 5)


def test_kernel_source_and_build_key():
    """K4's aGRAAL core is built from its own CUDA source for sm_90a, with
    K2's flags, on the header K2 and K4 share, with no library kernel standing
    in; K2's and K4's sources are not touched by it."""
    src = trb.AGRAAL_SOURCE.read_text()
    assert trb.AGRAAL_SOURCE.name == "resident_agraal.cu" and trb.AGRAAL_SOURCE != trb.SOURCE
    assert '#include "resident_common.cuh"' in src and "adaprox_resident_agraal" in src
    assert "__global__" in src and "grid.sync()" in src
    assert "-fmad=false" in trb.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in trb.NVCC_FLAGS
    for banned in ("cublas", "wmma", "mma.sync", "torch", "use_fast_math", "atomicAdd"):
        assert banned not in src.split('#include "resident_common.cuh"', 1)[1]
    assert "resident_agraal" not in trb.SOURCE.read_text()
