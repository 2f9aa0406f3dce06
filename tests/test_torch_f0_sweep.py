"""K7a's plain versions against the JAX package, on the same numpy inputs (f64 on the
CPU unless a test says f32): the f = 0 coupling sweeps ``resident_mpls_sweep`` (the
Malitsky-Pock core) and ``resident_adapdmp_sweep`` (the AdaPDM+ core) of
``adaprox_tpu_torch/ops/resident_f0.py``, their records (``resident_mp_records``,
``resident_adapdmp_records``), and the port's engine on the same problems.

The JAX side runs K7a in interpret mode, as tests/test_kernels.py does; the port's
entries take their plain versions on CPU tensors. The CUDA kernel is tested on the
card (tests/test_torch_cuda.py) and by chip_smoke.py.

About the tolerances. At 128x128, ts [0.5, 1, 2] and 60 iterations the plain cores
agreed with JAX's interpret-mode kernel to 8e-13 (MP's norm_res, l2) and 1.2e-14 or
better elsewhere, with every trial count equal, so the rows are held to rtol 1e-9
(norm_res 1e-8, x rtol 1e-8 / atol 1e-12, as JAX's own engine tests hold its kernel)
and the counts, the trial counts and ls_failed exactly. bf16 storage keeps f32
iterates on both sides; the summation orders differ (torch.mv against jnp.sum), so
those runs are held as JAX holds them: to the f32-storage run's solution.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of
from test_torch_pd import COUNTERS, _close, t64

import adaprox_tpu_torch as apt
from adaprox_tpu.ops import resident as jr
from adaprox_tpu_torch.ops import resident_f0 as tf
from adaprox_tpu_torch.ops import resident_mp as tmp

F64 = torch.float64
INNERS = ("l2", "l1")
TS = [0.5, 1.0, 2.0]
MAXIT = 60
CORES = {
    "mp": (jr.resident_mpls_sweep, jr.resident_mp_records, tf.resident_mpls_sweep,
           tmp.resident_mp_records),
    "adapdmp": (jr.resident_adapdmp_sweep, jr.resident_adapdmp_records,
                tf.resident_adapdmp_sweep, tf.resident_adapdmp_records),
}


def f0_case(m=128, n=128, seed=4):
    """tests/test_kernels.py's K7a problem: A (m, n) Gaussian, bv = A w + noise with a
    sparse w, lam 1. Returns (a, bv, lam, p2 of each core: sigma0 = 1 for MP, eta0 =
    ||A||_F for AdaPDM+)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    w_true = rng.standard_normal(n) * (rng.random(n) < 0.2)
    bv = a @ w_true + 0.1 * rng.standard_normal(m)
    return a, bv, 1.0, {"mp": 1.0, "adapdmp": float(np.linalg.norm(a))}


def _both(core, a, bv, lam, p2, tol, maxit, h_kind):
    jfn, _, tfn, _ = CORES[core]
    want = jfn(jnp.asarray(a), jnp.asarray(bv), lam, jnp.asarray(TS, jnp.float64), p2, tol,
               maxit, record=True, h_kind=h_kind, interpret=True)
    got = tfn(t64(a), t64(bv), lam, TS, p2, tol, maxit, record=True, h_kind=h_kind)
    return got, want


def _sweeps_match(got, want):
    assert got[1].dtype == torch.int32 and got[3].dtype == got[4].dtype == torch.bool
    np.testing.assert_array_equal(np_of(got[1]), np_of(want[1]))
    np.testing.assert_array_equal(np_of(got[3]), np_of(want[3]))
    np.testing.assert_array_equal(np_of(got[4]), np_of(want[4]))
    np.testing.assert_array_equal(np_of(got[5][3]), np_of(want[5][3]))  # trials
    for k in (0, 1, 4):  # gamma, sigma, objective
        _close(got[5][k], want[5][k])
    _close(got[5][2], want[5][2], rtol=1e-8)
    _close(got[2], want[2], rtol=1e-8)
    _close(got[0], want[0], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("h_kind", INNERS)
@pytest.mark.parametrize("core", list(CORES))
def test_k7a_plain_matches_jax(core, h_kind):
    """Every output of the sweep at tol 0 against JAX's interpret-mode K7a: numit, the
    trial counts, converged and ls_failed exactly; the histories, norm_res and x to
    the tolerances of the module docstring."""
    a, bv, lam, p2 = f0_case()
    got, want = _both(core, a, bv, lam, p2[core], 0.0, MAXIT, h_kind)
    assert tuple(got[0].shape) == (3, 128) and all(h.shape == (3, MAXIT) for h in got[5])
    _sweeps_match(got, want)
    # the linesearch ran: some iteration took more than one trial
    assert int(got[5][3].max()) > 1


@pytest.mark.parametrize("core", list(CORES))
def test_k7a_plain_converged_matches_jax(core):
    """At tol 1e-4 every row stops early, at JAX's iteration, and returns JAX's x: MP
    the last accepted iterate (final.x), AdaPDM+ the iterate at the check. (NormL2: on
    these problems the NormL1 rows do not reach 1e-4 in 3000 iterations.)"""
    a, bv, lam, p2 = f0_case()
    got, want = _both(core, a, bv, lam, p2[core], 1e-4, 3000, "l2")
    assert bool(got[3].all()) and int(got[1].max()) < 3000
    _sweeps_match(got, want)


@pytest.mark.parametrize("h_kind", INNERS)
@pytest.mark.parametrize("core", list(CORES))
def test_k7a_records_match_jax(core, h_kind):
    """Each row's ``Records`` against JAX's records of the same row: every counter,
    ``it`` and ``valid`` equal, the columns to rtol 1e-9 (norm_res 1e-8)."""
    a, bv, lam, p2 = f0_case()
    got, want = _both(core, a, bv, lam, p2[core], 1e-4, 200, h_kind)
    _, jrec, _, trec = CORES[core]
    for i in range(len(TS)):
        rt = trec(got[1][i], tuple(h[i] for h in got[5]), maxit=200)
        rj = jrec(want[1][i], tuple(h[i] for h in want[5]), maxit=200)
        for k in ("it", "valid") + COUNTERS:
            np.testing.assert_array_equal(np_of(getattr(rt, k)), np_of(getattr(rj, k)), k)
        for k in ("gamma", "sigma", "objective"):
            _close(getattr(rt, k), getattr(rj, k))
        _close(rt.norm_res, rj.norm_res, rtol=1e-8)


def _engine(core, a, bv, lam, p2, t, h_kind, maxit):
    """The port's engine on the same problem: malitsky_pock or
    adaptive_linesearch_primal_dual with ZeroSmooth, L1Norm and Translate."""
    m, n = a.shape
    inner = apt.L2Norm(1.0) if h_kind == "l2" else apt.L1Norm(1.0)
    kw = dict(f=apt.ZeroSmooth(), g=apt.L1Norm(lam), h=apt.Translate(inner, -t64(bv)),
              A=apt.DenseOperator(t64(a)), t=t, tol=0.0, maxit=maxit, history=True)
    x0, y0 = torch.zeros(n, dtype=F64), torch.zeros(m, dtype=F64)
    if core == "mp":
        return apt.malitsky_pock(x0, y0, sigma=p2, **kw)
    return apt.adaptive_linesearch_primal_dual(x0, y0, eta=p2, **kw)


def _rows_match_engine(core, got, i, ref, maxit):
    recs = CORES[core][3](got[1][i], tuple(h[i] for h in got[5]), maxit=maxit)
    for k in ("gamma", "sigma", "objective"):
        _close(getattr(recs, k), getattr(ref.records, k))
    _close(recs.norm_res, ref.records.norm_res, rtol=1e-8)
    for k in COUNTERS:
        np.testing.assert_array_equal(np_of(getattr(recs, k)), np_of(getattr(ref.records, k)), k)


@pytest.mark.parametrize("h_kind", INNERS)
@pytest.mark.parametrize("core", list(CORES))
def test_k7a_plain_matches_the_engine(core, h_kind):
    """As tests/test_kernels.py holds JAX's kernel: each row of the plain sweep against
    the port's engine at its t, row for row (gamma, sigma, objective to rtol 1e-9,
    norm_res 1e-8, every counter equal) and in x."""
    a, bv, lam, p2 = f0_case()
    got = CORES[core][2](t64(a), t64(bv), lam, TS, p2[core], 0.0, MAXIT, record=True,
                         h_kind=h_kind)
    for i, t in enumerate(TS):
        ref = _engine(core, a, bv, lam, p2[core], t, h_kind, MAXIT)
        _rows_match_engine(core, got, i, ref, MAXIT)
        _close(got[0][i], ref.x, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("h_kind", INNERS)
@pytest.mark.parametrize("core", list(CORES))
def test_k7a_padding_is_exact(core, h_kind):
    """The housing-like 100 x 13 problem zero-padded to 128 x 128 (A and bv), as the
    drivers pad it, against the engine on the unpadded problem: the padded
    coordinates of x exactly 0, the rows and x as in the engine test."""
    a, bv, lam, p2 = f0_case(100, 13, seed=2)
    a_pad, bv_pad = np.zeros((128, 128)), np.zeros(128)
    a_pad[:100, :13], bv_pad[:100] = a, bv
    # eta0 stays the unpadded ||A||_F (padding adds zeros)
    got = CORES[core][2](t64(a_pad), t64(bv_pad), lam, TS, p2[core], 0.0, MAXIT, record=True,
                         h_kind=h_kind)
    assert not bool(got[0][:, 13:].any())
    for i, t in enumerate(TS):
        ref = _engine(core, a, bv, lam, p2[core], t, h_kind, MAXIT)
        _rows_match_engine(core, got, i, ref, MAXIT)
        _close(got[0][i, :13], ref.x, rtol=1e-8, atol=1e-12)


def test_k7a_bf16_storage_matches_jax():
    """bf16 A with an f32 bv (tests/test_kernels.py:1201-1225 and :876-897): the
    iterates are f32 on both sides, and on the same bf16 values each core converges
    to JAX's bf16 solution (MP at 64x128, lam 0.05, t 0.5, tol 1e-4; AdaPDM+ at 32x16,
    lam 0.1, four t, tol 1e-9, 40 iterations) within JAX's own bf16-vs-f32 bounds;
    the f32 sums in two orders agree closer than those."""
    rng = np.random.default_rng(7)
    a32 = (rng.standard_normal((64, 128)) / np.sqrt(64)).astype(np.float32)
    xs = np.zeros(128)
    xs[:6] = rng.standard_normal(6)
    bv = (a32 @ xs + 0.01 * rng.standard_normal(64)).astype(np.float32)
    aj, at_ = jnp.asarray(a32).astype(jnp.bfloat16), torch.as_tensor(a32).to(torch.bfloat16)
    want = jr.resident_mpls_sweep(aj, jnp.asarray(bv), 0.05, jnp.asarray([0.5], jnp.float32), 1.0,
                                  1e-4, 3000, h_kind="l2", interpret=True)
    got = tf.resident_mpls_sweep(at_, torch.as_tensor(bv), 0.05, [0.5], 1.0, 1e-4, 3000,
                                 h_kind="l2")
    assert got[0].dtype == torch.float32 and bool(got[3][0]) and bool(want[3][0])
    _close(got[0], want[0], rtol=5e-2, atol=3e-2)

    rng = np.random.default_rng(4)
    a32 = rng.standard_normal((32, 16)).astype(np.float32)
    bv = rng.standard_normal(32).astype(np.float32)
    ts = np.geomspace(0.1, 10.0, 4).astype(np.float32)
    na = float(np.linalg.norm(a32))
    aj, at_ = jnp.asarray(a32).astype(jnp.bfloat16), torch.as_tensor(a32).to(torch.bfloat16)
    want = jr.resident_adapdmp_sweep(aj, jnp.asarray(bv), 0.1, jnp.asarray(ts), na, 1e-9, 40,
                                     interpret=True)
    got = tf.resident_adapdmp_sweep(at_, torch.as_tensor(bv), 0.1, ts, na, 1e-9, 40)
    assert got[0].dtype == torch.float32 and bool(torch.isfinite(got[0]).all())
    _close(got[0], want[0], rtol=0.15, atol=0.05)


@pytest.mark.parametrize("core", list(CORES))
def test_k7a_sweep_row_equals_its_one_row_call(core):
    """Each row of a three-row sweep equals the one-row sweep at its t, exactly."""
    a, bv, lam, p2 = f0_case()
    fn = CORES[core][2]
    out = fn(t64(a), t64(bv), lam, TS, p2[core], 1e-4, 200, record=True, h_kind="l1")
    for i, t in enumerate(TS):
        one = fn(t64(a), t64(bv), lam, [t], p2[core], 1e-4, 200, record=True, h_kind="l1")
        for u, w in zip(one[:5] + tuple(one[5]), out[:5] + tuple(out[5])):
            assert torch.equal(u[0], w[i])


@pytest.mark.parametrize("core", list(CORES))
def test_k7a_zero_iterations_match_jax(core):
    """maxit 0: JAX's zero-iteration result (x0 or x1 = 0, numit 0, norm_res inf, not
    converged, no linesearch failure); with records, empty histories. (JAX's
    interpret mode cannot record at maxit 0: its history block has length 0.)"""
    a, bv, lam, p2 = f0_case()
    jfn, _, tfn, _ = CORES[core]
    want = jfn(jnp.asarray(a), jnp.asarray(bv), lam, jnp.asarray(TS, jnp.float64), p2[core],
               0.0, 0, h_kind="l2", interpret=True)
    for record in (False, True):
        got = tfn(t64(a), t64(bv), lam, TS, p2[core], 0.0, 0, record=record, h_kind="l2")
        assert got[1].tolist() == np_of(want[1]).tolist() == [0, 0, 0]
        assert np.isinf(np_of(got[2])).all() and np.isinf(np_of(want[2])).all()
        assert not bool(got[3].any()) and not bool(got[4].any()) and not np_of(want[4]).any()
        _close(got[0], want[0], rtol=0, atol=0)
        assert len(got) == (6 if record else 5)
    assert all(h.shape == (3, 0) for h in got[5])


@pytest.mark.parametrize("core", list(CORES))
def test_k7a_entries_validate_before_running(core, monkeypatch):
    """Every refusal comes before any compute, on the entry and on its plain version:
    p2 (sigma0 or eta0) not positive, a non-positive or non-finite t, ts not 1-D or
    empty, h_kind, shapes, maxit, and a device that is neither CPU nor CUDA."""
    fn = CORES[core][2]
    plain = {"mp": tf.resident_mpls_sweep_plain, "adapdmp": tf.resident_adapdmp_sweep_plain}[core]
    p2_name = {"mp": "sigma0", "adapdmp": "eta0"}[core]

    def boom(*args, **kw):
        raise AssertionError("a core ran")

    monkeypatch.setattr(tf, "_mpls_core_plain", boom)
    monkeypatch.setattr(tf, "_adapdmp_core_plain", boom)
    a, bv = torch.zeros((128, 64), dtype=F64), torch.zeros(128, dtype=F64)
    for entry in (fn, plain):
        for p2 in (0.0, -1.0):
            with pytest.raises(ValueError, match=p2_name):
                entry(a, bv, 1.0, TS, p2, 1e-5, 5)
        for ts in ([1.0, 0.0], [-0.5], [float("nan")], [float("inf")]):
            with pytest.raises(ValueError, match="coupling t must be positive"):
                entry(a, bv, 1.0, ts, 1.0, 1e-5, 5)
        for ts in ([], [[0.5, 1.0]]):
            with pytest.raises(ValueError, match="one dimension"):
                entry(a, bv, 1.0, ts, 1.0, 1e-5, 5)
        with pytest.raises(ValueError, match="h_kind"):
            entry(a, bv, 1.0, TS, 1.0, 1e-5, 5, h_kind="linf")
        with pytest.raises(ValueError, match="need a"):
            entry(a, bv[:64], 1.0, TS, 1.0, 1e-5, 5)
        with pytest.raises(ValueError, match="maxit"):
            entry(a, bv, 1.0, TS, 1.0, 1e-5, -1)
    with pytest.raises(ValueError, match="CPU .plain version. or CUDA"):
        fn(a.to("meta"), bv.to("meta"), 1.0, TS, 1.0, 1e-5, 5)


def test_k7a_calibration_device_and_readings(capsys, monkeypatch):
    """experiments/k7a_calibration.py: --device is cuda unless the caller asks for the CPU,
    and is refused without a card; a cut-down --mode horizon run on the CPU prints one line
    a (A dtype, h, core) case, f32 against f64 on the driver's padded housing_scale inputs,
    within the bounds that the card's checks are held to."""
    from adaprox_tpu_torch.experiments import k7a_calibration as cal

    assert 1.0 in cal.K7A_TS and cal.K7A_HORIZON < cal.K7A_CUT
    assert set(cal.K7A_L1_TS) == set(CORES) == set(cal.CORES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.main(["--mode", "horizon"])
    threads = torch.get_num_threads()
    try:
        cal.main(["--mode", "horizon", "--device", "cpu", "--datasets", "housing_scale",
                  "--ts", "1", "--cut", "8", "--horizon", "4"])
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 8
    assert {(ln["a"], ln["h_kind"], ln["core"]) for ln in lines} == {
        (a, h, c) for a in ("float32", "bfloat16") for h in INNERS for c in CORES}
    for ln in lines:
        assert ln["shape"] == [512, 128] and len(ln["rows"]) == 1
        row = ln["rows"][0]
        assert row["trials_differ_at"] is None and row["ls_failed"] == [False, False]
        assert row["rows_err"] <= cal.K7A_RTOL and row["x_rel"] <= cal.K7A_X_RTOL
