"""Prox functions, curvature reductions and stepsize rules of the PyTorch
port against the JAX package, on the same numpy inputs (f64 on the CPU)."""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
from adaprox_tpu.solvers.rules import Curvature as JCurv
from adaprox_tpu_torch.solvers.rules import Curvature as TCurv, validate_positive

F64 = torch.float64


def _t(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


# -- prox ------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [0.0, 1e-3, 0.37, 5.0])
@pytest.mark.parametrize("lam", [0.0, 0.3, 2.0])
def test_l1norm_and_zero_match_jax(gamma, lam):
    v = gaussian(7, 257) * 2
    v[:5] = [0.0, -0.0, gamma * lam, -gamma * lam, 1e-300]  # thresholds and signed zeros
    for jop, top in ((ap.L1Norm(lam=lam), apt.L1Norm(lam)), (ap.Zero(), apt.Zero())):
        yj, gyj = jop.prox(jnp.asarray(v), jnp.asarray(gamma))
        yt, gyt = top.prox(_t(v), _t(gamma))
        # elementwise closed forms: the same IEEE operations, bit for bit
        np.testing.assert_array_equal(np_of(yt), np_of(yj))
        # g(y) sums n terms in another order: ~n * eps
        np.testing.assert_allclose(float(gyt), float(gyj), rtol=1e-13)
        np.testing.assert_allclose(float(top(_t(v))), float(jop(jnp.asarray(v))), rtol=1e-13)
        assert yt.dtype == F64 and gyt.shape == ()


# -- curvature --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_curvature_of_matches_jax(seed):
    x1, g1, x0, g0 = (gaussian(seed * 10 + k, 300) for k in range(4))
    cj = JCurv.of(*(jnp.asarray(v) for v in (x1, g1, x0, g0)))
    ct = TCurv.of(*(_t(v) for v in (x1, g1, x0, g0)))
    for k in ("ndg2", "dgdx", "ndx2"):
        # 300-term sums in another order: rtol ~ n * eps
        np.testing.assert_allclose(float(getattr(ct, k)), float(getattr(cj, k)), rtol=1e-12)
    # identical iterates: exact zeros on both sides
    cz = TCurv.of(_t(x1), _t(g1), _t(x1), _t(g1))
    assert all(float(v) == 0.0 for v in cz)


# -- rules ------------------------------------------------------------------


RULES = {
    "fixed": (dict(gamma=0.3, t=2.0), ap.FixedStepsize, apt.FixedStepsize),
    "mm": (dict(gamma=0.05, t=1.0), ap.MalitskyMishchenkoRule, apt.MalitskyMishchenkoRule),
    "mm_t": (dict(gamma=0.05, t=0.5), ap.MalitskyMishchenkoRule, apt.MalitskyMishchenkoRule),
    "adapgm": (dict(gamma=0.02), ap.AdaPGMRule, apt.AdaPGMRule),
    "adapgm_coupled": (dict(gamma=0.02, t=0.5, norm_a=2.3, delta=0.1, theta=1.5),
                       ap.AdaPGMRule, apt.AdaPGMRule),
    "adapgm_t": (dict(gamma=0.02, t=2.0, norm_a=0.7), ap.AdaPGMRule, apt.AdaPGMRule),
}

_Z, _INF = 0.0, math.inf
EDGE_CURVS = [
    (_Z, _Z, _Z),              # identical iterates: 0/0 everywhere
    (1.0, 10.0, 1.0),          # gamma1 * C < 1: D < 0
    (1e-12, 0.0, 1e-10),       # dgdx underflowed to 0 near convergence
    (4.0, -1.0, 2.0),          # negative curvature product
    (_INF, 1.0, 1.0),          # overflowed gradient difference
    (1.0, 1.0, _INF),          # overflowed iterate difference
    (math.nan, 1.0, 1.0),      # poisoned reduction: NaN must propagate alike
]


def _curv_sequence(seed, steps):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        dg, dx = rng.standard_normal(12), rng.standard_normal(12)
        out.append((dg @ dg, dg @ dx, dx @ dx))
    return out


def _run(rule, curv_cls, seq, to_scalar):
    (g, s), st = rule.init()
    out = [(float(g), float(s))]
    for c in seq:
        (g, s), st = rule.update(st, curv_cls(*(to_scalar(v) for v in c)))
        out.append((float(g), float(s)))
    return np.array(out)


@pytest.mark.parametrize("name", sorted(RULES))
@pytest.mark.parametrize("case", ["random", "edges"])
def test_rule_sequences_match_jax(name, case):
    kw, jcls, tcls = RULES[name]
    seq = _curv_sequence(sorted(RULES).index(name), 10) if case == "random" else EDGE_CURVS
    if case == "edges":  # each edge case after a normal step, then a normal step
        seq = [c for e in seq for c in (_curv_sequence(1, 1)[0], e)] + _curv_sequence(2, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        gj = _run(jcls(**kw), JCurv, seq, lambda v: jnp.asarray(v, jnp.float64))
    gt = _run(tcls(**kw).to(dtype=F64, device="cpu"), TCurv, seq, lambda v: torch.tensor(v, dtype=F64))
    # the same IEEE operations in the same order on 0-d f64 values
    np.testing.assert_allclose(gt, gj, rtol=1e-14, atol=0, equal_nan=True)


def test_adapgm_make_and_resolve_match_jax():
    for kw in (dict(t=2.0, norm_a=3.0), dict(gamma=0.01, norm_a=1.0),
               dict(gamma=0.01, norm_a=0.0), dict(gamma=None, t=0.5, norm_a=2.0, theta=2.0)):
        np.testing.assert_allclose(float(apt.AdaPGMRule.make(**kw).gamma),
                                   float(ap.AdaPGMRule.make(**kw).gamma), rtol=1e-15)
    # above the coupling bound: clamped with a warning on both sides
    with pytest.warns(UserWarning, match="coupling bound"):
        jg = float(ap.AdaPGMRule.make(gamma=1.0, t=1.0, norm_a=2.0, delta=0.1).gamma)
    with pytest.warns(UserWarning, match="coupling bound"):
        tg = float(apt.AdaPGMRule.make(gamma=1.0, t=1.0, norm_a=2.0, delta=0.1).gamma)
    assert tg == jg
    for mod in (ap, apt):
        with pytest.raises(ValueError, match="norm_A = 0"):
            mod.AdaPGMRule.make(t=1.0, norm_a=0.0)


@pytest.mark.parametrize("ctor,bad", [
    (apt.FixedStepsize, dict(gamma=0.0)),
    (apt.FixedStepsize, dict(gamma=0.1, t=-1.0)),
    (apt.MalitskyMishchenkoRule, dict(gamma=-0.5)),
    (apt.MalitskyMishchenkoRule, dict(gamma=float("nan"))),
    (apt.AdaPGMRule, dict(gamma=0.0)),
    (apt.AdaPGMRule, dict(gamma=0.1, theta=-1.0)),
])
def test_rule_constructors_validate_eagerly(ctor, bad):
    """No tracers in the port: direct constructors validate (the JAX
    package's direct constructors cannot; only its .make does)."""
    with pytest.raises(ValueError, match="must be positive"):
        ctor(**bad)


def test_validate_positive_matches_jax_rules():
    from adaprox_tpu.solvers.rules import validate_positive as jvp

    for ok in (2.0, np.float32(2.0), np.asarray(0.5), torch.tensor(0.5)):
        validate_positive(gamma=ok)
    for bad, exc in ((-1.0, ValueError), (np.float32(-1.0), ValueError), (0, ValueError),
                     (True, TypeError), (np.bool_(True), TypeError),
                     (np.asarray(True), TypeError), (1 + 2j, TypeError),
                     (np.complex128(-1), TypeError), (np.asarray(1 + 2j), TypeError)):
        with pytest.raises(exc):
            validate_positive(gamma=bad)
        with pytest.raises(exc):
            jvp(gamma=bad)
    for bad, exc in ((torch.tensor(-0.5), ValueError), (torch.tensor(True), TypeError),
                     (torch.tensor(1 + 2j), TypeError)):
        with pytest.raises(exc):
            validate_positive(gamma=bad)


@pytest.mark.parametrize("name", ["fixed", "mm", "adapgm_coupled"])
def test_rule_from_numpy_carries_jax_fields(name):
    kw, jcls, _ = RULES[name]
    jr = jcls(**{k: jnp.asarray(v) for k, v in kw.items()})
    fields = {k: np.asarray(getattr(jr, k)) for k in kw}
    tr = apt.rule_from_numpy(jcls.__name__, **fields)
    seq = _curv_sequence(5, 6)
    gj = _run(jr, JCurv, seq, lambda v: jnp.asarray(v, jnp.float64))
    gt = _run(tr.to(dtype=F64, device="cpu"), TCurv, seq, lambda v: torch.tensor(v, dtype=F64))
    np.testing.assert_allclose(gt, gj, rtol=1e-14)
    with pytest.raises(ValueError, match="unknown rule"):
        apt.rule_from_numpy("AdaPGMPlusRule", gamma=np.asarray(0.1))
