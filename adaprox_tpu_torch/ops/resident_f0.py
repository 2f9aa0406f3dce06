"""The whole-solve kernels of the f = 0 composite family: the square-root lasso
and the least absolute deviation,

    min_x lam ||x||_1 + h(A x),   h = Translate(inner, -bv),   inner = NormL2 or NormL1

(experiments/square_root_lasso/runme.jl:37-47, 80-95).

Counterpart of ``adaprox_tpu/ops/resident.py:1529-2316``:
  * K7d, ``resident_condat_vu`` (``_cv_kernel[_rec]`` over ``_cv_core`` on
    ``_f0_ops``): one Condat-Vu solve with fixed steps (gamma, sigma); its
    records are ``resident_pd.resident_cv_records``, one function in JAX too.
  * K7a, ``resident_mpls_sweep`` and ``resident_adapdmp_sweep`` (``_f0_sweep``
    over ``_mpls_core`` or ``_adapdmp_core``): one early-exit Malitsky-Pock or
    AdaPDM+ solve for each coupling t of a sweep, the linesearch included. The
    MP records are ``resident_mp.resident_mp_records`` (shared with K6c, as in
    JAX); the AdaPDM+ records are ``resident_adapdmp_records``.
  * K7b, ``resident_mpls_grid`` and ``resident_adapdmp_grid`` (``_f0_grid``): K7a's
    solves for every (dataset, t) cell of D datasets zero-padded to one common shape,
    d-major, each dataset with its own lam and sigma0 or eta0.
  * K7c, ``resident_cv_grid`` (``_cv_grid_kernel_rec``): K7d's solve, recorded, for
    each of the D datasets, each with its own lam, gamma and sigma.
Here the entries reach hand-written CUDA C++ kernels for Hopper: K7d and K7c one kernel
in ``csrc/resident_cv.cu``, K7a and K7b one kernel a core in ``csrc/resident_f0_grid.cu``
(both cores' routines in ``csrc/resident_f0_cores.cuh``), all on ``csrc/resident_f0.cuh``.
A grid launch over one dataset is K7a's sweep (K7d's solve), as JAX's grids are its
sweeps with a dataset axis. Each entry is one kernel launch, built with nvcc for ``sm_90a``
at first use and loaded with ctypes: K7d and K7c a cooperative grid that runs the datasets
one after another; K7a and K7b a persistent grid of thread-block clusters, one (dataset,
t) cell a cluster at a time, the cells at once, each cell's rows of A in its cluster's
shared memory where they fit (``f0_grid_plan`` says how a shape is laid out).

The entries dispatch on where their tensors lie: CPU tensors take the plain
versions (``*_plain``: the JAX cores line by line, one host-checked iteration,
and for the linesearch one host-checked trial, at a time); CUDA tensors
launch the kernel or raise. A may be stored bf16; the iterates and scalars
follow ``bv``'s dtype. Zero padding is exact for this family: padded rows of A
and bv and padded columns of A leave their coordinates of y and x exactly 0,
so the kernels take no unpadded size.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solvers.common import Records
from ..solvers.rules import validate_positive
from . import kernels
from .resident_pd import _device, _scalars, _stats, _ts, hist_len

__all__ = ["resident_condat_vu", "resident_condat_vu_plain", "resident_mpls_sweep",
           "resident_mpls_sweep_plain", "resident_adapdmp_sweep", "resident_adapdmp_sweep_plain",
           "resident_adapdmp_records", "resident_mpls_grid", "resident_mpls_grid_plain",
           "resident_adapdmp_grid", "resident_adapdmp_grid_plain", "resident_cv_grid",
           "resident_cv_grid_plain", "build_library", "build_grid_library", "f0_grid_plan",
           "H_KINDS"]

SOURCE = kernels._PKG / "csrc" / "resident_cv.cu"
# -fmad=false: every elementwise expression rounds after each operation, as the
# plain version's tensor ops do (the kernel's dot products use explicit fmaf)
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
# h's inner norm: "l2", the square-root lasso; "l1", the least absolute deviation
H_KINDS = ("l2", "l1")


def _check(a, bv, maxit, h_kind, what="resident_condat_vu"):
    if a.ndim != 2 or bv.ndim != 1 or a.shape[0] != bv.shape[0]:
        raise ValueError(f"{what}: need a (m, n) and bv (m,); got "
                         f"{tuple(a.shape)}, {tuple(bv.shape)}")
    if a.device != bv.device:
        raise ValueError(f"{what}: a and bv on different devices: {a.device}, {bv.device}")
    if h_kind not in H_KINDS:
        raise ValueError(f"{what}: h_kind must be 'l2' or 'l1', got {h_kind!r}")
    if int(maxit) < 0:
        raise ValueError(f"{what}: maxit must be >= 0, got {maxit}")


def _soft(v, thr):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)


def _f0_ops(a, bv, lam, h_kind):
    """``_f0_ops``: (a_mv, at_mv, prox_hconj, objective) on vectors, A in bv's dtype
    (bf16 storage is upcast, as JAX's elementwise products promote it)."""
    a = a.to(bv.dtype)

    def a_mv(x):
        return torch.mv(a, x)

    def at_mv(y):
        return torch.mv(a.t(), y)

    def prox_hconj(w, sigma):
        # Moreau: prox_{sigma h*}(w) = w - sigma prox_{h/sigma}(w/sigma), and
        # h = Translate(inner, -bv): prox_{tau h}(u) = prox_{tau inner}(u - bv) + bv
        z = w / sigma - bv
        if h_kind == "l1":
            p = _soft(z, 1.0 / sigma)
        else:
            nz = torch.sqrt(torch.sum(z * z))
            p = torch.where(nz > 0, torch.clamp_min(1.0 - (1.0 / sigma) / nz, 0.0),
                            torch.zeros_like(nz)) * z
        return w - sigma * (p + bv)

    def objective(x, a_x):
        diff = a_x - bv
        h_val = (torch.sum(torch.abs(diff)) if h_kind == "l1"
                 else torch.sqrt(torch.sum(diff * diff)))
        return lam * torch.sum(torch.abs(x)) + h_val

    return a_mv, at_mv, prox_hconj, objective


def resident_condat_vu_plain(a, bv, lam, gamma, sigma, tol, maxit, record=False, h_kind="l2"):
    """The plain version of K7d, ``_cv_core`` line by line: the engine's loop with
    FixedStepsize and f = 0 (rho = 1, the record snapshot before the second half),
    from x0 = 0, y0 = 0. Returns what ``resident_condat_vu`` returns."""
    _check(a, bv, maxit, h_kind)
    dt, dev = bv.dtype, bv.device
    maxit = int(maxit)
    lam, gamma, sigma, tol = _scalars(dt, dev, lam, gamma, sigma, tol)
    a_mv, at_mv, prox_hconj, obj_of = _f0_ops(a, bv, lam, h_kind)
    m, n = a.shape
    # warm-up (the engine's _init): x0 = 0, y0 = 0
    x0 = torch.zeros(n, dtype=dt, device=dev)
    y = torch.zeros(m, dtype=dt, device=dev)
    a_x_prev = a_mv(x0)
    at_y = at_mv(y)
    v = x0 - gamma * at_y
    x = _soft(v, gamma * lam)
    ck_x = x
    hl = hist_len(maxit)
    hr = torch.zeros(hl, dtype=dt, device=dev) if record else None
    ho = torch.zeros(hl, dtype=dt, device=dev) if record else None
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        a_x = a_mv(x)
        primal = (v - x) / gamma + at_y
        w = y + sigma * (2.0 * a_x - a_x_prev)  # rho = 1 fixed rule
        y = prox_hconj(w, sigma)
        dual = (w - y) / sigma - a_x
        norm_res = torch.sqrt(torch.sum(primal * primal) + torch.sum(dual * dual))
        if record:
            hr[it], ho[it] = norm_res, obj_of(x, a_x)
        at_y = at_mv(y)
        v = x - gamma * at_y
        ck_x, a_x_prev = x, a_x
        x = _soft(v, gamma * lam)
        it += 1
    conv = norm_res <= tol
    stats = _stats(dt, dev, it, norm_res, conv.to(dt))
    # the engine's return: the iterate AT the convergence check
    base = (torch.where(conv, ck_x, x), stats[0].to(torch.int32), stats[1].to(dt), stats[2] > 0)
    if record:
        return base + ((hr[:maxit], ho[:maxit]),)
    return base


# -- K7a's plain versions ----------------------------------------------------------------

# the initial trial and up to 100 halvings (MP) or inflations (AdaPDM+): the engines'
# _MAX_TRIALS = 100
MAX_TRIALS = 101
# AdaPDM+'s constants (_adapdmp_core's defaults, the engine's and the reference's)
DELTA, THETA_BIG, R_UP, R_DOWN = 1e-8, 1.2, 2.0, 0.95
# the sweeps' cores, in the order of the kernel entry's core argument
CORES = ("mp", "adapdmp")


def _mpls_core_plain(a, bv, lam, t, sigma0, tol, *, maxit, h_kind, record):
    """``_mpls_core`` line by line: Malitsky-Pock with f = 0 from x0 = 0, y0 = 0,
    sigma x sqrt(2) a first trial, halved while gamma sigma ||A dx||^2 > 0.95
    ||dx||^2, at most MAX_TRIALS trials (a test still failing then is latched).
    Returns (x, it, norm_res, converged, ls_failed, hists (5, hist_len) or None):
    ``final.x``, not the iterate at the check."""
    dt, dev = bv.dtype, bv.device
    a_mv, at_mv, prox_hconj, obj_of = _f0_ops(a, bv, lam, h_kind)
    t, sigma, tol = _scalars(dt, dev, t, sigma0, tol)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dt, device=dev))
    m, n = a.shape
    x = torch.zeros(n, dtype=dt, device=dev)
    y = torch.zeros(m, dtype=dt, device=dev)
    a_x, at_y = a_mv(x), at_mv(y)
    hists = torch.zeros((5, hist_len(maxit)), dtype=dt, device=dev) if record else None
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    ls_failed = False
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        at_y_prev = at_y
        w = y + sigma * a_x
        y = prox_hconj(w, sigma)
        at_y = at_mv(y)
        sigma_prev = sigma
        x_prev, a_x_prev = x, a_x
        s, trials = sigma * sqrt2, 1
        while True:
            theta = s / sigma_prev
            gamma = t * t * s
            at_ybar = (1 + theta) * at_y - theta * at_y_prev
            v = x_prev - gamma * at_ybar  # grad = 0
            x = _soft(v, gamma * lam)
            a_x = a_mv(x)
            dax = a_x - a_x_prev
            lhs = gamma * s * torch.sum(dax * dax)  # the f = 0 terms vanish
            dx = x - x_prev
            failed = bool(lhs > 0.95 * torch.sum(dx * dx))  # the host sync of each trial
            if not (failed and trials < MAX_TRIALS):
                break
            s, trials = s / 2, trials + 1
        ls_failed = ls_failed or failed
        primal = (v - x) / gamma + at_y
        dual = (w - y) / sigma_prev - a_x
        norm_res = torch.sqrt(torch.sum(primal * primal) + torch.sum(dual * dual))
        if record:
            hists[:, it] = torch.stack([gamma, s, norm_res,
                                        torch.tensor(float(trials), dtype=dt, device=dev),
                                        obj_of(x, a_x)])
        sigma = s
        it += 1
    return x, it, norm_res, norm_res <= tol, ls_failed, hists


def _adapdmp_core_plain(a, bv, lam, t, eta0, tol, *, maxit, h_kind, record):
    """``_adapdmp_core`` line by line: AdaPDM+ with f = 0 (big_delta = 0) from x0 =
    0, y0 = 0 and gamma0 = 1/(2 Theta t eta0): eta decays by R_DOWN a first trial
    and inflates by R_UP while eta < ||A'dy|| / ||dy||, at most MAX_TRIALS trials.
    Returns what ``_mpls_core_plain`` returns; on convergence x is the iterate at
    the check."""
    dt, dev = bv.dtype, bv.device
    a_mv, at_mv, prox_hconj, obj_of = _f0_ops(a, bv, lam, h_kind)
    t, eta, tol, zero = _scalars(dt, dev, t, eta0, tol, 0.0)
    gamma0 = 1.0 / (2 * THETA_BIG * t * eta)
    delta1 = 1.0 + DELTA
    m, n = a.shape
    # warm-up (engine :66-84): x0 = 0, y0 = 0; grad = 0 throughout (f = 0)
    x0 = torch.zeros(n, dtype=dt, device=dev)
    y = torch.zeros(m, dtype=dt, device=dev)
    a_x_prev, at_y = a_mv(x0), at_mv(y)
    v = x0 - gamma0 * at_y
    x = ck_x = _soft(v, gamma0 * lam)
    gamma = gamma_prev = gamma0
    hists = torch.zeros((5, hist_len(maxit)), dtype=dt, device=dev) if record else None
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    ls_failed = False
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        a_x = a_mv(x)
        primal = (v - x) / gamma + at_y
        # big_delta = gamma (gamma ||dg||^2 - dgdx) / ||dx||^2 with dg = 0
        xi = t * gamma * eta * delta1
        m4xim1 = 1 - 4 * (xi * xi)
        e, trials = R_DOWN * eta, 1
        while True:
            p = t * e * gamma
            gamma_next = torch.minimum(
                gamma * torch.sqrt(1 + gamma / gamma_prev),
                torch.minimum(1 / (2 * THETA_BIG * t * e),
                              gamma * torch.sqrt(m4xim1 / (2 * delta1 * (zero + torch.sqrt(
                                  zero * zero + m4xim1 * (p * p)))))))
            rho = gamma_next / gamma
            sigma = t * t * gamma_next
            w = y + sigma * ((1 + rho) * a_x - rho * a_x_prev)
            y_next = prox_hconj(w, sigma)
            at_y_next = at_mv(y_next)
            daty, dy = at_y_next - at_y, y_next - y
            # the host sync of each trial; a NaN ratio (dy = 0) fails it
            ok = bool(e >= torch.sqrt(torch.sum(daty * daty)) / torch.sqrt(torch.sum(dy * dy)))
            if ok or trials >= MAX_TRIALS:
                break
            e, trials = e * R_UP, trials + 1
        ls_failed = ls_failed or not ok
        dual = (w - y_next) / sigma - a_x
        norm_res = torch.sqrt(torch.sum(primal * primal) + torch.sum(dual * dual))
        if record:
            hists[:, it] = torch.stack([gamma_next, sigma, norm_res,
                                        torch.tensor(float(trials), dtype=dt, device=dev),
                                        obj_of(x, a_x)])
        y, at_y, eta = y_next, at_y_next, e
        v = x - gamma_next * at_y
        ck_x, a_x_prev = x, a_x
        x = _soft(v, gamma_next * lam)
        gamma_prev, gamma = gamma, gamma_next
        it += 1
    conv = norm_res <= tol
    return torch.where(conv, ck_x, x), it, norm_res, conv, ls_failed, hists


def _couplings(what, ts):
    """The couplings as float64 on the host: one dimension of at least one value, each
    positive and finite. JAX's kernels run any t: t = 0 gives 0/0 residuals, a negative
    t AdaPDM+'s gamma0 < 0 and MP the run of |t|. Refused here, as the engines refuse
    them."""
    ts = _ts(ts, torch.float64)
    if not bool((torch.isfinite(ts) & (ts > 0)).all()):
        raise ValueError(f"{what}: every coupling t must be positive and finite, got "
                         f"{ts.tolist()}")
    return ts


def _sweep_check(what, a, bv, ts, maxit, h_kind, **positive):
    """Everything a K7a entry refuses, before anything runs, on either device. Returns
    the couplings as float64 on the host."""
    validate_positive(**positive)
    _check(a, bv, maxit, h_kind, what)
    return _couplings(what, ts)


def _sweep_plain(core, a, bv, lam, ts, p2, tol, maxit, record, h_kind):
    dt, dev = bv.dtype, bv.device
    maxit = int(maxit)
    lam_t = torch.as_tensor(lam, dtype=dt, device=dev)
    outs = [core(a, bv, lam_t, t, p2, tol, maxit=maxit, h_kind=h_kind, record=record)
            for t in ts.to(dt).tolist()]
    # the TPU kernel's stats travel as f32
    stats = torch.stack([_stats(dt, dev, o[1], o[2], o[3].to(dt), float(o[4])) for o in outs])
    base = (torch.stack([o[0] for o in outs]), stats[:, 0].to(torch.int32), stats[:, 1].to(dt),
            stats[:, 2] > 0, stats[:, 3] > 0)
    if record:
        hists = torch.stack([o[5] for o in outs])  # (T, 5, hist_len)
        return base + (tuple(hists[:, k, :maxit] for k in range(5)),)
    return base


def resident_mpls_sweep_plain(a, bv, lam, ts, sigma0, tol, maxit, record=False, h_kind="l2"):
    """The plain version of K7a's MP core: one ``_mpls_core`` solve a coupling value,
    in order. Returns what ``resident_mpls_sweep`` returns."""
    ts = _sweep_check("resident_mpls_sweep", a, bv, ts, maxit, h_kind, sigma0=sigma0)
    return _sweep_plain(_mpls_core_plain, a, bv, lam, ts, sigma0, tol,
                        maxit, record, h_kind)


def resident_adapdmp_sweep_plain(a, bv, lam, ts, eta0, tol, maxit, record=False, h_kind="l2"):
    """The plain version of K7a's AdaPDM+ core: one ``_adapdmp_core`` solve a coupling
    value, in order. Returns what ``resident_adapdmp_sweep`` returns."""
    ts = _sweep_check("resident_adapdmp_sweep", a, bv, ts, maxit, h_kind, eta0=eta0)
    return _sweep_plain(_adapdmp_core_plain, a, bv, lam, ts, eta0, tol, maxit, record,
                        h_kind)


# -- K7b's and K7c's plain versions: the dataset grids -------------------------------------


def _table(what, name, vals, dcount, positive):
    """A per-dataset scalar table as float64 on the host: (D,), real, finite and, for the
    steps, positive."""
    if isinstance(vals, torch.Tensor):
        if vals.dtype == torch.bool or vals.is_complex():
            raise TypeError(f"{what}: {name} must be real numbers, got {vals.dtype}")
        arr = vals.detach().to("cpu", torch.float64).numpy()
    else:
        arr = np.asarray(vals)
        if arr.dtype == np.bool_ or not np.issubdtype(arr.dtype, np.number) or np.iscomplexobj(
                arr):
            raise TypeError(f"{what}: {name} must be real numbers, got {arr.dtype}")
        arr = arr.astype(np.float64)
    if arr.shape != (dcount,):
        raise ValueError(f"{what}: {name} must hold one value a dataset, shape ({dcount},); "
                         f"got {arr.shape}")
    if not np.isfinite(arr).all() or (positive and not (arr > 0).all()):
        kind = "positive and finite" if positive else "finite"
        raise ValueError(f"{what}: every entry of {name} must be {kind}, got {arr.tolist()}")
    return torch.as_tensor(arr)


def _grid_check(what, a_stack, bv_stack, maxit, h_kind, ts=None, **tables):
    """Everything a grid entry refuses, before anything runs, on either device: a_stack
    (D, m, n) with D >= 1 and bv_stack (D, m) on one device, h_kind, maxit >= 0; each
    table (D,) and finite, ``lams`` of any sign (as the sweeps take lam), the steps (sigma0s,
    eta0s, gammas, sigmas) positive; with ``ts``, every coupling positive and finite (the
    sweeps' rule). Returns the tables, then the couplings, as float64 host tensors."""
    if (a_stack.ndim != 3 or bv_stack.ndim != 2 or tuple(bv_stack.shape) != tuple(
            a_stack.shape[:2]) or a_stack.shape[0] < 1):
        raise ValueError(f"{what}: need a_stack (D, m, n) with D >= 1 and bv_stack (D, m); got "
                         f"{tuple(a_stack.shape)}, {tuple(bv_stack.shape)}")
    if a_stack.device != bv_stack.device:
        raise ValueError(f"{what}: a_stack and bv_stack on different devices: "
                         f"{a_stack.device}, {bv_stack.device}")
    if h_kind not in H_KINDS:
        raise ValueError(f"{what}: h_kind must be 'l2' or 'l1', got {h_kind!r}")
    if int(maxit) < 0:
        raise ValueError(f"{what}: maxit must be >= 0, got {maxit}")
    dcount = a_stack.shape[0]
    out = [_table(what, name, vals, dcount, positive=name != "lams")
           for name, vals in tables.items()]
    if ts is not None:
        out.append(_couplings(what, ts))
    return out


def _grid_plain(core, a_stack, bv_stack, lams, ts, p2s, tol, maxit, record, h_kind):
    """The (dataset x t) grid as the plain sweep of each dataset on its slice, stacked."""
    outs = [_sweep_plain(core, a_stack[d], bv_stack[d], float(lams[d]), ts, float(p2s[d]), tol,
                         maxit, record, h_kind) for d in range(a_stack.shape[0])]
    base = tuple(torch.stack([o[k] for o in outs]) for k in range(5))
    if record:
        return base + (tuple(torch.stack([o[5][k] for o in outs]) for k in range(5)),)
    return base


def resident_mpls_grid_plain(a_stack, bv_stack, lams, ts, sigma0s, tol, maxit, record=False,
                             h_kind="l2"):
    """The plain version of K7b's MP core: ``resident_mpls_sweep_plain`` on each
    dataset's slice with its lam and sigma0. Returns what ``resident_mpls_grid``
    returns."""
    lams, sigma0s, ts = _grid_check("resident_mpls_grid", a_stack, bv_stack, maxit, h_kind, ts,
                                    lams=lams, sigma0s=sigma0s)
    return _grid_plain(_mpls_core_plain, a_stack, bv_stack, lams, ts, sigma0s, tol, maxit,
                       record, h_kind)


def resident_adapdmp_grid_plain(a_stack, bv_stack, lams, ts, eta0s, tol, maxit, record=False,
                                h_kind="l2"):
    """The plain version of K7b's AdaPDM+ core: ``resident_adapdmp_sweep_plain`` on each
    dataset's slice with its lam and eta0. Returns what ``resident_adapdmp_grid``
    returns."""
    lams, eta0s, ts = _grid_check("resident_adapdmp_grid", a_stack, bv_stack, maxit, h_kind, ts,
                                  lams=lams, eta0s=eta0s)
    return _grid_plain(_adapdmp_core_plain, a_stack, bv_stack, lams, ts, eta0s, tol, maxit,
                       record, h_kind)


def _cv_grid_plain(a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, h_kind):
    outs = [resident_condat_vu_plain(a_stack[d], bv_stack[d], float(lams[d]), float(gammas[d]),
                                     float(sigmas[d]), tol, maxit, record=True, h_kind=h_kind)
            for d in range(a_stack.shape[0])]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4)) + (
        tuple(torch.stack([o[4][k] for o in outs]) for k in range(2)),)


def resident_cv_grid_plain(a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, h_kind="l2"):
    """The plain version of K7c: ``resident_condat_vu_plain`` in record mode on each
    dataset's slice with its lam, gamma and sigma. Returns what ``resident_cv_grid``
    returns."""
    lams, gammas, sigmas = _grid_check("resident_cv_grid", a_stack, bv_stack, maxit, h_kind,
                                       lams=lams, gammas=gammas, sigmas=sigmas)
    return _cv_grid_plain(a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, h_kind)


def resident_adapdmp_records(numit, hists, *, maxit):
    """``Records`` of one resident AdaPDM+ row from its histories (gamma, sigma,
    norm_res, trials, objective). The counters are rebuilt from the trial counts as
    the engine meters them (solvers/adapdm_plus.py): each iteration A, f and grad_f
    +1, prox_h and At + trials, prox_g +1 (the second half); the warm-up A, f,
    grad_f, At and prox_g +1. The record precedes the second half's prox_g, so row k
    reads k. Rows past ``numit`` are masked out by ``valid``."""
    hg, hs, hr, ht, ho = hists
    dev = hg.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    cum_t = torch.cumsum(ht.to(torch.int64), 0)
    return Records(it=it, gamma=hg, sigma=hs, norm_res=hr, objective=ho, f_evals=1 + it,
                   grad_f_evals=1 + it, prox_g_evals=it, prox_h_evals=cum_t, A_evals=1 + it,
                   At_evals=1 + cum_t, valid=it <= torch.as_tensor(numit, device=dev))


# -- the CUDA kernels --------------------------------------------------------------------


def _storage(what, a, bv):
    """The checks every launch makes of A (f32 or bf16) and bv (f32)."""
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} stores A as float32 or bfloat16 on CUDA, got {a.dtype}")
    if bv.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 bv on CUDA, got {bv.dtype}")
    if not (a.is_contiguous() and bv.is_contiguous()):
        raise ValueError(f"{what} needs contiguous a and bv")


def _layouts(what, a, bv):
    """``_storage``'s checks, and A's second layout, A' (the last two dimensions swapped),
    with the vector width both take: 16-byte loads when both layouts' rows are whole
    16-byte groups (then so is every dataset's slice of a stack)."""
    _storage(what, a, bv)
    at = a.transpose(-2, -1).contiguous()
    m, n = a.shape[-2:]
    vec = 8 if a.dtype == torch.bfloat16 else 4
    if m % vec or n % vec or a.data_ptr() % 16 or at.data_ptr() % 16:
        vec = 1
    return at, vec


def _row_vec(a):
    """The vector width of K7a/K7b's reads of A's rows: 16-byte loads when a row is whole
    16-byte groups (then so is every row of every dataset's slice)."""
    vec = 8 if a.dtype == torch.bfloat16 else 4
    return 1 if a.shape[-1] % vec or a.data_ptr() % 16 else vec


def _partials(parts, dev):
    """The per-CTA partials: the launcher sizes the grid, at most one CTA per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty(parts * sms, dtype=torch.float32, device=dev)


def _cv_scratch(m, n, dev):
    """K7d's and K7c's scratch, in the entries' order: xs (2, n), v, at_y (n), y, ax, w
    (m)."""
    f32 = dict(dtype=torch.float32, device=dev)
    return [torch.empty((2, n), **f32), torch.empty(n, **f32), torch.empty(n, **f32),
            torch.empty(m, **f32), torch.empty(m, **f32), torch.empty(m, **f32)]


def _ptrs(bufs):
    return [b.data_ptr() for b in bufs]


def _raise_on(err, what, error_string):
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def build_library():
    """Compile ``csrc/resident_cv.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_resident_f0_parts": ([], i),
        # a, at, a_is_bf16, vec, m, n, bv, h_kind, lams, gammas, sigmas, dcount, xs, v, at_y,
        # y, ax, w, part, part_len, tol, maxit, record, x_out, stats, hist, stream
        "adaprox_resident_cv_grid": ([p, p, i, i, ll, ll, p, i, p, p, p, i, p, p, p, p, p, p, p,
                                      ll, f, i, i, p, p, p, p], i),
        "adaprox_resident_cv_error_string": ([i], ctypes.c_char_p)})


def _cv_launch(what, a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, record, h_kind):
    """One launch of the Condat-Vu kernel over the D datasets of the stack: K7c, or K7d at
    D = 1. The tables are float64 host tensors. Returns what ``resident_cv_grid``
    returns, the histories only when ``record``."""
    at, vec = _layouts(what, a_stack, bv_stack)
    lib = _library()
    dev = a_stack.device
    dcount, m, n = a_stack.shape
    maxit = int(maxit)
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        lams_d, gammas_d, sigmas_d = (v.to(**f32) for v in (lams, gammas, sigmas))
        scratch = _cv_scratch(m, n, dev)
        part = _partials(lib.adaprox_resident_f0_parts(), dev)
        x_out, stats = torch.empty((dcount, n), **f32), torch.empty((dcount, 3), **f32)
        hist = torch.empty((dcount, 2, hist_len(maxit)), **f32) if record else None
        err = lib.adaprox_resident_cv_grid(
            a_stack.data_ptr(), at.data_ptr(), int(a_stack.dtype == torch.bfloat16), vec, m, n,
            bv_stack.data_ptr(), H_KINDS.index(h_kind), lams_d.data_ptr(), gammas_d.data_ptr(),
            sigmas_d.data_ptr(), dcount, *_ptrs(scratch), part.data_ptr(), part.numel(),
            float(tol), maxit, int(record), x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, what, lib.adaprox_resident_cv_error_string)
    base = (x_out, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 2] > 0)
    if record:
        return base + ((hist[:, 0, :maxit], hist[:, 1, :maxit]),)
    return base


def _one(value):
    """The float64 host table of one dataset."""
    return torch.tensor([float(value)], dtype=torch.float64)


def _first(out):
    """A one-dataset launch's outputs without the dataset axis (the histories last)."""
    return tuple(tuple(h[0] for h in o) if isinstance(o, tuple) else o[0] for o in out)


def resident_condat_vu(a, bv, lam, gamma, sigma, tol, maxit, record=False, h_kind="l2"):
    """Whole-solve Condat-Vu for min lam ||x||_1 + ||A x - bv|| (``h_kind`` "l2")
    or lam ||x||_1 + ||A x - bv||_1 (``h_kind`` "l1") in one kernel launch, from
    x0 = 0, y0 = 0, with the fixed steps (gamma, sigma). ``a`` (m, n), ``bv`` (m,).

    Returns (x (n,), numit, norm_res, converged), plus ((norm_res_hist,
    objective_hist),) of shape (maxit,) when ``record=True`` (zero past numit; the
    objective lam ||x||_1 + h(A x) at the iteration's x); ``resident_pd.
    resident_cv_records`` turns them into ``Records``. On convergence x is the
    iterate at the check. CPU tensors take the plain version, any float dtype.
    CUDA tensors launch K7d, the Condat-Vu kernel of ``csrc/resident_cv.cu`` over one
    dataset: ``a`` f32 or bf16, ``bv`` f32, both contiguous; each launch adds one to
    ``resident_condat_vu.launches``."""
    if not _device("K7d", a):
        return resident_condat_vu_plain(a, bv, lam, gamma, sigma, tol, maxit, record, h_kind)
    _check(a, bv, maxit, h_kind)
    out = _cv_launch("K7d", a[None], bv[None], _one(lam), _one(gamma), _one(sigma), tol, maxit,
                     record, h_kind)
    resident_condat_vu.launches += 1
    return _first(out)


resident_condat_vu.launches = 0


# -- K7a and K7b on the card ----------------------------------------------------------------

GRID_SOURCE = kernels._PKG / "csrc" / "resident_f0_grid.cu"
# what adaprox_resident_f0_grid_plan returns, in its order
PLAN_KEYS = ("cluster", "clusters", "smem_bytes", "rows_per_cta", "rows_held",
             "vectors_in_smem", "scratch_floats")


def build_grid_library():
    """Compile ``csrc/resident_f0_grid.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(GRID_SOURCE, NVCC_FLAGS)


def _grid_library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kernels.load_library(GRID_SOURCE, NVCC_FLAGS, {
        # m, n, a_is_bf16, vec, core, cells, out (7)
        "adaprox_resident_f0_grid_plan": ([ll, ll, i, i, i, i, ctypes.POINTER(ll)], i),
        # a, a_is_bf16, vec, m, n, bv, h_kind, lams, p2s, dcount, core, counter, scratch,
        # scratch_len, ts, count, tol, maxit, record, x_out, stats, hist, stream
        "adaprox_resident_f0_grid": ([p, i, i, ll, ll, p, i, p, p, i, i, p, p, ll, p, i, f, i, i,
                                      p, p, p, p], i),
        "adaprox_resident_f0_grid_error_string": ([i], ctypes.c_char_p)})


def _grid_plan(lib, what, core, m, n, bf16, vec, cells):
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = lib.adaprox_resident_f0_grid_plan(m, n, int(bf16), vec, CORES.index(core), cells, out)
    _raise_on(err, what, lib.adaprox_resident_f0_grid_error_string)
    plan = dict(zip(PLAN_KEYS, (int(v) for v in out)))
    plan["whole"] = bool(plan["rows_held"] == plan["rows_per_cta"] and plan["vectors_in_smem"])
    return plan


def f0_grid_plan(a, core, cells):
    """How K7a/K7b lay out a launch of ``core`` ("mp" or "adapdmp") over A (m, n) or a stack
    (D, m, n) on the card with ``cells`` (dataset, t) cells: the cluster size C (picked
    from the shape alone), the clusters the launch runs at once, the dynamic shared memory
    of a CTA in bytes, the rows of A a CTA owns and those it holds in shared memory,
    whether the vectors are in shared memory (else in a scratch in device memory), the
    floats of that scratch, and ``whole``: the cell's A and vectors all in shared memory."""
    lib = _grid_library()
    with torch.cuda.device(a.device):
        return _grid_plan(lib, "f0_grid_plan", core, a.shape[-2], a.shape[-1],
                          a.dtype == torch.bfloat16, _row_vec(a), int(cells))


def _grid_launch(what, core, a_stack, bv_stack, lams, ts, p2s, tol, maxit, record, h_kind):
    """One launch of a core's kernel over the D datasets of the stack: K7b, or K7a at D =
    1. The tables and couplings are float64 host tensors. Returns what the grid entries
    return."""
    _storage(what, a_stack, bv_stack)
    vec = _row_vec(a_stack)
    bf16 = a_stack.dtype == torch.bfloat16
    lib = _grid_library()
    dev = a_stack.device
    dcount, m, n = a_stack.shape
    maxit = int(maxit)
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        lams_d, p2s_d, ts_d = (v.to(**f32) for v in (lams, p2s, ts))
        count = ts_d.numel()
        plan = _grid_plan(lib, what, core, m, n, bf16, vec, dcount * count)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)  # the next cell
        scratch = torch.empty(plan["scratch_floats"], **f32) if plan["scratch_floats"] else None
        x_out = torch.empty((dcount, count, n), **f32)
        stats = torch.empty((dcount, count, 4), **f32)
        hist = torch.empty((dcount, count, 5, hist_len(maxit)), **f32) if record else None
        err = lib.adaprox_resident_f0_grid(
            a_stack.data_ptr(), int(bf16), vec, m, n, bv_stack.data_ptr(), H_KINDS.index(h_kind),
            lams_d.data_ptr(), p2s_d.data_ptr(), dcount, CORES.index(core), counter.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, plan["scratch_floats"],
            ts_d.data_ptr(), count, float(tol), maxit, int(record), x_out.data_ptr(),
            stats.data_ptr(), hist.data_ptr() if record and maxit else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, what, lib.adaprox_resident_f0_grid_error_string)
    base = (x_out, stats[..., 0].to(torch.int32), stats[..., 1], stats[..., 2] > 0,
            stats[..., 3] > 0)
    if record:
        return base + (tuple(hist[:, :, k, :maxit] for k in range(5)),)
    return base


def _sweep_launch(what, core, a, bv, lam, ts, p2, tol, maxit, record, h_kind):
    """One K7a launch: a core's kernel over one dataset. Returns what the sweeps return."""
    return _first(_grid_launch(f"{what} (K7a)", core, a[None], bv[None], _one(lam), ts, _one(p2),
                               tol, maxit, record, h_kind))


def resident_mpls_sweep(a, bv, lam, ts, sigma0, tol, maxit, record=False, h_kind="l2"):
    """The Malitsky-Pock coupling sweep (square_root_lasso/runme.jl:80-88) as ONE
    kernel launch: a whole early-exit linesearch solve of min lam ||x||_1 + ||A x -
    bv|| (``h_kind`` "l2") or lam ||x||_1 + ||A x - bv||_1 ("l1") for each value of
    ``ts`` (on the card at once, each on a cluster of its own), from x0 = 0, y0 = 0 and the
    first dual step ``sigma0``. ``sigma0`` and every t must be positive, ``ts`` 1-D with at
    least one value (checked before anything runs, on either device).

    Returns (x (T, n), numit (T,) int32, norm_res (T,), converged (T,),
    ls_failed (T,)), plus the histories (gamma, sigma, norm_res, trials,
    objective) of shape (T, maxit) as a tuple when ``record=True`` (zero past
    numit); ``resident_mp.resident_mp_records`` turns a row into ``Records``. x is
    the last accepted iterate (``final.x``). CPU tensors take the plain version,
    any float dtype. CUDA tensors launch K7a, the MP kernel of
    ``csrc/resident_f0_grid.cu`` over one dataset: ``a`` f32 or bf16, ``bv`` f32, both
    contiguous; each launch adds one to ``resident_mpls_sweep.launches``. Every row
    equals a one-row sweep with its t bit for bit."""
    what = "resident_mpls_sweep"
    ts = _sweep_check(what, a, bv, ts, maxit, h_kind, sigma0=sigma0)
    if not _device("K7a", a):
        return _sweep_plain(_mpls_core_plain, a, bv, lam, ts, sigma0, tol, maxit, record,
                            h_kind)
    out = _sweep_launch(what, "mp", a, bv, lam, ts, sigma0, tol, maxit, record, h_kind)
    resident_mpls_sweep.launches += 1
    return out


resident_mpls_sweep.launches = 0


def resident_adapdmp_sweep(a, bv, lam, ts, eta0, tol, maxit, record=False, h_kind="l2"):
    """The AdaPDM+ coupling sweep (square_root_lasso/runme.jl:90-95) as ONE kernel
    launch: the contract of ``resident_mpls_sweep`` with the initial operator-norm
    estimate ``eta0`` (the drivers' ||A||_F, positive) in place of sigma0. On
    convergence a row's x is the iterate at the check. The histories feed
    ``resident_adapdmp_records``. CUDA tensors launch K7a's AdaPDM+ kernel; each
    launch adds one to ``resident_adapdmp_sweep.launches``."""
    what = "resident_adapdmp_sweep"
    ts = _sweep_check(what, a, bv, ts, maxit, h_kind, eta0=eta0)
    if not _device("K7a", a):
        return _sweep_plain(_adapdmp_core_plain, a, bv, lam, ts, eta0, tol, maxit, record,
                            h_kind)
    out = _sweep_launch(what, "adapdmp", a, bv, lam, ts, eta0, tol, maxit, record, h_kind)
    resident_adapdmp_sweep.launches += 1
    return out


resident_adapdmp_sweep.launches = 0


def resident_mpls_grid(a_stack, bv_stack, lams, ts, sigma0s, tol, maxit, record=False,
                       h_kind="l2"):
    """The Malitsky-Pock (dataset x t) grid (square_root_lasso/runme.jl:100-110 over the
    datasets x :80-88 over t) as ONE kernel launch: for each dataset d and each value of
    ``ts``, d-major, a whole early-exit linesearch solve of min lams[d] ||x||_1 + ||A_d x -
    bv_d|| (``h_kind`` "l2") or lams[d] ||x||_1 + ||A_d x - bv_d||_1 ("l1") from x0 = 0, y0
    = 0 and the first dual step sigma0s[d]. ``a_stack`` (D, m, n): the datasets
    zero-padded to one common shape (exact for this family); ``bv_stack`` (D, m); ``lams``
    and ``sigma0s`` (D,), finite, sigma0s positive; ``ts`` (T,), positive and finite
    (checked before anything runs, on either device).

    Returns ``resident_mpls_sweep``'s contract with a leading D axis: (x (D, T, n),
    numit (D, T) int32, norm_res, converged, ls_failed (D, T)), plus the five histories
    (D, T, maxit) when ``record=True``. CPU tensors take the plain version, any float
    dtype. CUDA tensors launch K7b (``csrc/resident_f0_grid.cu``): ``a_stack`` f32 or
    bf16, ``bv_stack`` f32, both contiguous; each launch adds one to
    ``resident_mpls_grid.launches``. Every cell equals the one-row K7a launch on its
    dataset's slice bit for bit."""
    what = "resident_mpls_grid"
    lams, sigma0s, ts = _grid_check(what, a_stack, bv_stack, maxit, h_kind, ts, lams=lams,
                                    sigma0s=sigma0s)
    if not _device("K7b", a_stack):
        return _grid_plain(_mpls_core_plain, a_stack, bv_stack, lams, ts, sigma0s, tol, maxit,
                           record, h_kind)
    out = _grid_launch(f"{what} (K7b)", "mp", a_stack, bv_stack, lams, ts, sigma0s, tol, maxit, record,
                       h_kind)
    resident_mpls_grid.launches += 1
    return out


resident_mpls_grid.launches = 0


def resident_adapdmp_grid(a_stack, bv_stack, lams, ts, eta0s, tol, maxit, record=False,
                          h_kind="l2"):
    """The AdaPDM+ (dataset x t) grid as ONE kernel launch: the contract of
    ``resident_mpls_grid`` with each dataset's operator-norm estimate ``eta0s[d]`` (the
    drivers' ||A_d||_F, positive) in place of sigma0s. On convergence a cell's x is the
    iterate at the check. CUDA tensors launch K7b's AdaPDM+ core; each launch adds one to
    ``resident_adapdmp_grid.launches``."""
    what = "resident_adapdmp_grid"
    lams, eta0s, ts = _grid_check(what, a_stack, bv_stack, maxit, h_kind, ts, lams=lams,
                                  eta0s=eta0s)
    if not _device("K7b", a_stack):
        return _grid_plain(_adapdmp_core_plain, a_stack, bv_stack, lams, ts, eta0s, tol, maxit,
                           record, h_kind)
    out = _grid_launch(f"{what} (K7b)", "adapdmp", a_stack, bv_stack, lams, ts, eta0s, tol, maxit, record,
                       h_kind)
    resident_adapdmp_grid.launches += 1
    return out


resident_adapdmp_grid.launches = 0


def resident_cv_grid(a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, h_kind="l2"):
    """Condat-Vu across all D datasets as ONE record-mode kernel launch (with the two
    t-grids, the whole f = 0 experiment is three launches): for each dataset d the solve
    of ``resident_condat_vu`` on its slice with the fixed steps (gammas[d], sigmas[d]) and
    lams[d]. ``a_stack`` (D, m, n) zero-padded to one common shape, ``bv_stack`` (D, m),
    ``lams``, ``gammas``, ``sigmas`` (D,), finite, the steps positive (checked before
    anything runs, on either device).

    Returns (x (D, n), numit (D,) int32, norm_res (D,), converged (D,), (norm_res_hist,
    objective_hist) each (D, maxit)), zero past numit; on convergence x is the iterate at
    the check. CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K7c (``csrc/resident_cv.cu``): ``a_stack`` f32 or bf16, ``bv_stack`` f32, both
    contiguous; each launch adds one to ``resident_cv_grid.launches``. Each dataset's
    solve equals the K7d launch on its slice bit for bit."""
    what = "resident_cv_grid"
    lams, gammas, sigmas = _grid_check(what, a_stack, bv_stack, maxit, h_kind, lams=lams,
                                       gammas=gammas, sigmas=sigmas)
    if not _device("K7c", a_stack):
        return _cv_grid_plain(a_stack, bv_stack, lams, gammas, sigmas, tol, maxit, h_kind)
    out = _cv_launch(f"{what} (K7c)", a_stack, bv_stack, lams, gammas, sigmas, tol, maxit,
                     True, h_kind)
    resident_cv_grid.launches += 1
    return out


resident_cv_grid.launches = 0
