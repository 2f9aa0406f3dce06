"""K6a, K6b and K6d, the whole-solve primal-dual kernels of the dual SVM:
min 0.5 x'Qx - 1'x over 0 <= x <= C with labels'x = 0, as f = 0.5 x'Qx - 1'x,
g = IndBox(0, C), h = IndZero and A = labels' (the dual variable is a scalar).

Counterpart of ``adaprox_tpu/ops/resident.py:765-1517, 2134``:
``resident_adapdm_dsvm`` (K6a, one AdaPDM solve, dense Q, core ``_pd_core``),
``resident_adapdm_dsvm_sweep`` (K6b, the coupling-t sweep, dense Q or factored
B with Q = B B'), ``resident_cv_dsvm`` (K6d, one Condat-Vu solve with fixed
steps, core ``_dsvm_cv_core``) and the records ``resident_pd_records`` /
``resident_cv_records``. Here each is hand-written CUDA C++ for Hopper, built
with nvcc for ``sm_90a`` at first use and loaded with ctypes, as K2
(``ops/resident.py``): K6b and K6a launch the AdaPDM core of
``csrc/resident_dsvm_grid.cu`` (each value of t a whole solve on its own
thread-block cluster, the rows at once; K6a is its launch over one row, so a
dense K6b row equals it bit for bit), which K6c (``ops/resident_mp.py``) shares
with its Malitsky-Pock core; K6d is one cooperative launch of
``csrc/resident_pd.cu``, one grid-wide barrier an iteration, each CTA's rows of
Q or B in shared memory where they fit. ``dsvm_grid_plan`` gives the cluster
layout of a K6a-K6c launch, ``k6d_plan`` K6d's.

Each entry dispatches on where its tensors lie: CPU tensors take the plain
versions ``*_plain`` (Python loops over the same iteration, one host-checked
iteration at a time); CUDA tensors launch the kernel or raise. Q (or B) may be
stored bf16; the iterates and scalars follow ``labels``' dtype. ``n_true``
is the unpadded point count of a zero-padded problem: the linear term is
masked to the first ``n_true`` coordinates, so the padded ones stay exactly 0.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..solvers.common import Records
from ..solvers.rules import validate_positive
from . import kernels

__all__ = ["resident_adapdm_dsvm", "resident_adapdm_dsvm_plain", "resident_adapdm_dsvm_sweep",
           "resident_adapdm_dsvm_sweep_plain", "resident_cv_dsvm", "resident_cv_dsvm_plain",
           "resident_pd_records", "resident_cv_records", "hist_len", "build_library",
           "build_grid_library", "dsvm_grid_plan", "k6d_plan"]

SOURCE = kernels._PKG / "csrc" / "resident_pd.cu"
GRID_SOURCE = kernels._PKG / "csrc" / "resident_dsvm_grid.cu"
# -fmad=false: every elementwise expression rounds after each operation, as the
# plain version's tensor ops do (the kernel's dot products use explicit fmaf)
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
THETA = 1.2  # the AdaPGM rule's Theta of the JAX kernels' scalar tables
_LANE = 128


def hist_len(maxit: int) -> int:
    """The JAX kernels' history length: ``maxit`` rounded up to 128."""
    return -(-maxit // _LANE) * _LANE


def _check(what, q, labels, maxit, n_true, factored):
    """The shapes every entry takes; returns the problem's n_true."""
    if labels.ndim != 1 or q.ndim != 2 or q.shape[0] != labels.shape[0]:
        raise ValueError(f"{what}: need q (N, N) or, factored, B (N, d) and labels (N,); got "
                         f"{tuple(q.shape)}, {tuple(labels.shape)}")
    n = q.shape[0]
    if not factored and q.shape[1] != n:
        raise ValueError(f"{what}: a dense Q must be square (N, N), got {tuple(q.shape)}")
    if q.device != labels.device:
        raise ValueError(f"{what}: q and labels on different devices: {q.device}, "
                         f"{labels.device}")
    if int(maxit) < 0:
        raise ValueError(f"{what}: maxit must be >= 0, got {maxit}")
    n_true = n if n_true is None else int(n_true)
    if not 0 <= n_true <= n:
        raise ValueError(f"{what}: n_true must be in [0, N={n}], got {n_true}")
    return n_true


def _scalars(dt, dev, *vals):
    return tuple(torch.as_tensor(v, dtype=dt, device=dev) for v in vals)


def _dsvm_obj(q, lab, n_true, factored):
    """The dual-SVM smooth oracle (``_dsvm_obj``): (qx_of, ones, a_mv), grad =
    qx - ones, f = 0.5 x.qx - ones.x. Dense: (Q x)_i = Q_i . x (Q symmetric);
    factored: B (B'x). ``ones`` is the masked linear term."""
    dt = lab.dtype
    q = q.to(dt)
    ones = (torch.arange(q.shape[0], device=lab.device) < n_true).to(dt)
    if factored:
        def qx_of(x):
            return torch.mv(q, torch.mv(q.t(), x))
    else:
        def qx_of(x):
            return torch.mv(q, x)

    def a_mv(x):  # the scalar labels'x
        return torch.sum(lab * x)

    return qx_of, ones, a_mv


def _clamp(v, zero, big_c):
    return torch.minimum(torch.maximum(v, zero), big_c)


def _pd_core_plain(q, lab, t, norm_a, big_c, tol, n_true, *, maxit, record, factored):
    """``_pd_core`` line by line. Returns (x, it, norm_res, gamma, conv, hg, hr)
    with the histories (hist_len(maxit),) or None."""
    dt, dev = lab.dtype, lab.device
    qx_of, ones, a_mv = _dsvm_obj(q, lab, n_true, factored)
    t, norm_a, big_c, tol, theta, zero = _scalars(dt, dev, t, norm_a, big_c, tol, THETA, 0.0)
    n = q.shape[0]
    # warm-up (src/AdaProx.jl:324-332); y0 = 0
    gamma0 = 1.0 / (2 * theta * t * norm_a)
    x0 = torch.zeros(n, dtype=dt, device=dev)
    a_x_prev = a_mv(x0)
    grad_prev = qx_of(x0) - ones
    v = x0 - gamma0 * grad_prev  # A'y0 = 0
    x = _clamp(v, zero, big_c)
    x_prev, ck_x = x0, x
    hl = hist_len(maxit)
    hg = torch.zeros(hl, dtype=dt, device=dev) if record else None
    hr = torch.zeros(hl, dtype=dt, device=dev) if record else None
    y = torch.zeros((), dtype=dt, device=dev)
    at_y = torch.zeros(n, dtype=dt, device=dev)
    gamma = g1 = g0 = gamma0
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        a_x = a_mv(x)
        grad = qx_of(x) - ones
        primal = (v - x) / gamma + grad + at_y
        # AdaPGM rule with the coupling (solvers/rules.AdaPGMRule.update)
        dg = grad - grad_prev
        dx = x - x_prev
        ndg2, dgdx, ndx2 = torch.sum(dg * dg), torch.sum(dg * dx), torch.sum(dx * dx)
        dd_raw = g1 * (g1 * ndg2 - dgdx) / ndx2
        dd = torch.where(torch.isnan(dd_raw), zero, dd_raw)
        xi = t * t * g1 * g1 * norm_a * norm_a
        m4 = 1 - 4 * xi
        denom = torch.maximum(dd + torch.sqrt(dd * dd + xi * m4), zero)
        step = torch.minimum(
            g1 * torch.sqrt(1 + g1 / g0),
            torch.minimum(1 / (2 * theta * t * norm_a),
                          g1 * torch.sqrt(m4) / torch.sqrt(2.0 * denom)))
        sigma = step * t * t
        rho = step / gamma
        w = y + sigma * ((1 + rho) * a_x - rho * a_x_prev)
        y = w  # prox of (IndZero)* = Zero: identity
        # dual_res = (w - y)/sigma - a_x = -a_x
        norm_res = torch.sqrt(torch.sum(primal * primal) + a_x * a_x)
        if record:
            hg[it], hr[it] = step, norm_res
        at_y = lab * y
        v = x - step * (grad + at_y)
        x_prev, ck_x, a_x_prev, grad_prev = x, x, a_x, grad
        x = _clamp(v, zero, big_c)
        gamma, g0, g1 = step, g1, step
        it += 1
    conv = norm_res <= tol
    # the engine's return (the iterate AT the convergence check)
    return torch.where(conv, ck_x, x), it, norm_res, gamma, conv, hg, hr


def _stats(dt, dev, *vals):
    """The TPU kernel's stats travel as f32: numit, norm_res and gamma round
    through it."""
    return torch.stack([torch.as_tensor(v, dtype=dt, device=dev) for v in vals]).to(
        torch.float32)


def resident_adapdm_dsvm_plain(q, labels, big_c, t, norm_a, tol, maxit, n_true=None):
    """The plain version of K6a (``_pd_kernel`` over ``_pd_core``): returns what
    ``resident_adapdm_dsvm`` returns."""
    n_true = _check("resident_adapdm_dsvm", q, labels, maxit, n_true, False)
    dt, dev = labels.dtype, labels.device
    x, it, nres, gamma, conv, _, _ = _pd_core_plain(q, labels, t, norm_a, big_c, tol, n_true,
                                                    maxit=int(maxit), record=False,
                                                    factored=False)
    stats = _stats(dt, dev, it, nres, gamma, conv.to(dt))
    return x, stats[0].to(torch.int32), stats[1].to(dt), stats[3] > 0


def _ts(ts, dt):
    """The couplings as the JAX sweeps cast them: the iterate dtype, on the host;
    one dimension of at least one value."""
    ts = np.asarray(ts.cpu() if isinstance(ts, torch.Tensor) else ts, dtype=np.float64)
    if ts.ndim != 1 or ts.size < 1:
        raise ValueError(f"ts must be one dimension of at least one coupling value, got shape "
                         f"{ts.shape}")
    return torch.as_tensor(ts).to(dt)


def resident_adapdm_dsvm_sweep_plain(q, labels, big_c, ts, norm_a, tol, maxit, n_true=None,
                                     record=False, factored=False):
    """The plain version of K6b: one ``_pd_core`` solve a coupling value, in
    order. Returns what ``resident_adapdm_dsvm_sweep`` returns."""
    n_true = _check("resident_adapdm_dsvm_sweep", q, labels, maxit, n_true, factored)
    dt, dev = labels.dtype, labels.device
    outs = [_pd_core_plain(q, labels, t, norm_a, big_c, tol, n_true, maxit=int(maxit),
                           record=record, factored=factored) for t in _ts(ts, dt).tolist()]
    stats = torch.stack([_stats(dt, dev, o[1], o[2], o[3], o[4].to(dt)) for o in outs])
    base = (torch.stack([o[0] for o in outs]), stats[:, 0].to(torch.int32), stats[:, 1].to(dt),
            stats[:, 3] > 0)
    if record:
        return base + (torch.stack([o[5] for o in outs])[:, :maxit],
                       torch.stack([o[6] for o in outs])[:, :maxit])
    return base


def resident_cv_dsvm_plain(q, labels, big_c, gamma, sigma, tol, maxit, n_true=None,
                           record=False, factored=False):
    """The plain version of K6d, ``_dsvm_cv_core`` line by line (the engine
    with FixedStepsize: rho = 1, the record snapshot before the second half).
    Returns what ``resident_cv_dsvm`` returns."""
    n_true = _check("resident_cv_dsvm", q, labels, maxit, n_true, factored)
    dt, dev = labels.dtype, labels.device
    qx_of, ones, a_mv = _dsvm_obj(q, labels, n_true, factored)
    gamma, sigma, big_c, tol, zero = _scalars(dt, dev, gamma, sigma, big_c, tol, 0.0)
    n = q.shape[0]
    maxit = int(maxit)
    # warm-up (engine _init): x0 = 0, y0 = 0
    x0 = torch.zeros(n, dtype=dt, device=dev)
    a_x_prev = a_mv(x0)
    v = x0 - gamma * (qx_of(x0) - ones)  # at_y0 = 0
    x = _clamp(v, zero, big_c)
    ck_x = x
    hl = hist_len(maxit)
    hr = torch.zeros(hl, dtype=dt, device=dev) if record else None
    ho = torch.zeros(hl, dtype=dt, device=dev) if record else None
    y = torch.zeros((), dtype=dt, device=dev)
    at_y = torch.zeros(n, dtype=dt, device=dev)
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    it = 0
    while it < maxit and bool(norm_res > tol):
        a_x = a_mv(x)
        qx = qx_of(x)
        grad = qx - ones
        primal = (v - x) / gamma + grad + at_y
        w = y + sigma * (2.0 * a_x - a_x_prev)  # rho = 1 fixed rule
        y = w  # prox of (IndZero)* = Zero: identity
        norm_res = torch.sqrt(torch.sum(primal * primal) + a_x * a_x)
        if record:
            hr[it] = norm_res
            ho[it] = 0.5 * torch.sum(x * qx) - torch.sum(ones * x)
        at_y = labels * y
        v = x - gamma * (grad + at_y)
        a_x_prev, ck_x = a_x, x
        x = _clamp(v, zero, big_c)
        it += 1
    conv = norm_res <= tol
    stats = _stats(dt, dev, it, norm_res, conv.to(dt))
    base = (torch.where(conv, ck_x, x), stats[0].to(torch.int32), stats[1].to(dt), stats[2] > 0)
    if record:
        return base + ((hr[:maxit], ho[:maxit]),)
    return base


# -- the CUDA kernels --------------------------------------------------------------------


def build_library():
    """Compile ``csrc/resident_pd.cu``, K6d (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def build_grid_library():
    """Compile ``csrc/resident_dsvm_grid.cu``, K6a, K6b and K6c (see
    ``ops.kernels.build_library``)."""
    return kernels.build_library(GRID_SOURCE, NVCC_FLAGS)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the entries every build of csrc/resident_pd.cu has (experiments/k6_clusters.py loads another
# checkout's with these)
CV_SIGNATURES = {
    "adaprox_resident_pd_parts": ([], _I),
    # q, q_is_bf16, vec, factored, n, d, lab, n_true, big_c, xs, grad (not read), v, part,
    # part_len, gamma, sigma, tol, maxit, record, x_out, stats, hist, stream
    "adaprox_resident_cv": ([_P, _I, _I, _I, _LL, _LL, _P, _I, _F, _P, _P, _P, _P, _LL, _F, _F,
                             _F, _I, _I, _P, _P, _P, _P], _I),
    "adaprox_resident_pd_error_string": ([_I], ctypes.c_char_p)}


def _library():
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        **CV_SIGNATURES,
        # n, d, factored, itemsize, sms, out (K6D_PLAN_KEYS)
        "adaprox_resident_pd_plan": ([_LL, _LL, _I, _I, _I, ctypes.POINTER(_LL)], _I)})


def _grid_library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kernels.load_library(GRID_SOURCE, NVCC_FLAGS, {
        # n, d, factored, q_is_bf16, vec, core, rows, out (6)
        "adaprox_resident_dsvm_plan": ([ll, ll, i, i, i, i, i, ctypes.POINTER(ll)], i),
        # q, q_is_bf16, vec, factored, n, d, lab, n_true, big_c, core, counter, ts, count, p1,
        # p2, exact, tol, maxit, record, x_out, stats, hist, stream
        "adaprox_resident_dsvm_rows": ([p, i, i, i, ll, ll, p, i, f, i, p, p, i, f, f, i, f, i, i,
                                        p, p, p, p], i),
        "adaprox_resident_dsvm_error_string": ([i], ctypes.c_char_p)})


def _row_vec(q):
    """The vector width of Q's (or B's) rows: 16-byte loads where the row length and the
    storage's alignment allow them."""
    vec = 8 if q.dtype == torch.bfloat16 else 4
    return 1 if q.shape[1] % vec or q.data_ptr() % 16 else vec


def _storage(what, q, labels):
    """Check what the kernels take; returns the vector width of Q's (or B's) rows."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} stores Q (or B) as float32 or bfloat16 on CUDA, got {q.dtype}")
    if labels.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 labels on CUDA, got {labels.dtype}")
    if not (q.is_contiguous() and labels.is_contiguous()):
        raise ValueError(f"{what} needs contiguous q and labels")
    return _row_vec(q)


def _raise_on(err, what, error_string):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({error_string(err).decode()})")


def _launch(what, q, labels, n_true, big_c, factored, maxit, record, gamma, sigma, tol,
            lib=None):
    """One K6d launch with its scratch, from ``lib`` (default: the build of SOURCE). Returns
    (x_out (1, n), stats (1, 3), hist (1, 2, hist_len) or None)."""
    vec = _storage(what, q, labels)
    lib = lib or _library()
    dev = q.device
    n = q.shape[0]
    d = q.shape[1] if factored else 0
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        plan = k6d_plan(n, d, factored, q.element_size(), kernels._sm_count(dev.index))
        if plan is None:
            raise ValueError(f"{what}: B'x of d = {d} columns does not fit a CTA's shared "
                             f"memory (at most {K6D_MAX_D})")
        # grad is not read; it keeps the C entry's arguments
        xs, grad, v = torch.empty((2, n), **f32), torch.empty(n, **f32), torch.empty(n, **f32)
        if lib.adaprox_resident_pd_parts() != K6D_PARTS:
            raise RuntimeError("csrc/resident_pd.cu's kPdParts differs from K6D_PARTS")
        part = torch.empty(plan["part_len"], **f32)
        x_out, stats = torch.empty((1, n), **f32), torch.empty((1, 3), **f32)
        hist = torch.empty((1, 2, hist_len(maxit)), **f32) if record else None
        err = lib.adaprox_resident_cv(
            q.data_ptr(), int(q.dtype == torch.bfloat16), vec, int(factored), n, d,
            labels.data_ptr(), n_true, float(big_c), xs.data_ptr(), grad.data_ptr(),
            v.data_ptr(), part.data_ptr(), part.numel(), float(gamma), float(sigma), float(tol),
            maxit, int(record), x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"{what} launch", lib.adaprox_resident_pd_error_string)
    return x_out, stats, hist


# K6d's plan (csrc/resident_dsvm.cuh, pd_plan): 16 warps a CTA, at most one CTA an SM
K6D_WARPS = 16
K6D_PARTS = 4                # kPdParts: the scalar partials a CTA writes each pass
K6D_CTA_SMEM = 232448        # the most shared memory a CTA may take (227 KB)
K6D_STATIC_SMEM = 1024       # the kernel's static shared memory, rounded up
K6D_RED_THREADS = 512 - 32 * K6D_PARTS  # the threads that reduce B'x or stage x
K6D_SLOT_FLOATS = 3          # a held row's v, label and (factored) x
K6D_MAX_D = (K6D_CTA_SMEM - K6D_STATIC_SMEM - 16 * K6D_RED_THREADS) // 4
K6D_PLAN_KEYS = ("route", "grid", "rows_per_warp", "rows_per_cta", "smem_bytes", "x_shared",
                 "acc_shared", "part_len")
K6D_ROUTES = ("shared", "l2")


def _round16(nbytes):
    return -(-nbytes // 16) * 16


def k6d_plan(n, d, factored, itemsize, sms):
    """K6d's layout for Q (N, N) or, factored, B (N, d) with ``itemsize`` (4: f32, 2: bf16)
    storage on a card of ``sms`` SMs, as the C launcher computes it: a dict of K6D_PLAN_KEYS,
    or None where the shape is refused (factored d past K6D_MAX_D: B'x does not fit a CTA's
    shared memory).

    * ``grid``: min(ceil(N / 16), sms) CTAs of 16 warps; warp w of CTA c owns rows c * 16 + w,
      + 16 * grid, ...: ``rows_per_warp`` at most, ``rows_per_cta`` = 16 times that;
    * ``route``: "shared" where the CTA's rows of Q or B (``rows_per_cta`` x the row's bytes),
      each held row's v, label and x (12 bytes), the vector (x dense, B'x factored) and,
      factored, the B'x reduce's 6 KB and the 16 warps' partials of B'x fit 227 KB less 1 KB
      of static shared memory: the rows are loaded once a launch. Else "l2": the rows are
      read from device memory (through the L2) every pass;
    * ``x_shared``: x staged in shared memory each iteration (dense; True on "shared", and on
      "l2" up to N = 57856); ``acc_shared``: the warps' partials of B'x in shared memory
      (factored; else in ``part``); ``smem_bytes``: the CTA's dynamic shared memory;
    * ``part_len``: the floats of the partials' scratch: two halves of (4 + d) per CTA (d
      dense 0), plus the warps' partials of B'x where they are not in shared memory.

    The layout depends on the shape, the storage and the SM count alone; the dense bits do
    not depend on it at all (each row's dot and the partials' order are the same whichever
    memory holds the row)."""
    if itemsize not in (2, 4):
        raise ValueError(f"K6d stores Q (or B) as float32 or bfloat16, got itemsize {itemsize}")
    if n < 1 or sms < 1 or (factored and d < 1):
        raise ValueError(f"K6d needs n, sms >= 1 (and d >= 1 factored), got {n}, {d}, {sms}")
    length = d if factored else n
    grid = min(-(-n // K6D_WARPS), sms)
    rows_per_warp = -(-n // (grid * K6D_WARPS))
    rows_per_cta = K6D_WARPS * rows_per_warp
    budget = K6D_CTA_SMEM - K6D_STATIC_SMEM
    rows = (_round16(rows_per_cta * length * itemsize)
            + _round16(rows_per_cta * K6D_SLOT_FLOATS * 4))
    vec = _round16(4 * length)
    red = 16 * K6D_RED_THREADS if factored else 0
    acc = 4 * K6D_WARPS * d if factored else 0
    if rows + vec + red + acc <= budget:
        route, x_shared, acc_shared, smem = "shared", True, bool(factored), rows + vec + red + acc
    else:
        if factored and vec + red > budget:
            return None
        route = "l2"
        x_shared = vec <= budget
        acc_shared = bool(factored) and vec + red + acc <= budget
        smem = (vec if x_shared else 0) + red + (acc if acc_shared else 0)
    part_len = (2 * (K6D_PARTS + (d if factored else 0)) * grid
                + (grid * K6D_WARPS * d if factored and not acc_shared else 0))
    return dict(route=route, grid=grid, rows_per_warp=rows_per_warp, rows_per_cta=rows_per_cta,
                smem_bytes=smem, x_shared=x_shared, acc_shared=acc_shared, part_len=part_len)


def k6d_card_plan(n, d, factored, itemsize, sms):
    """The C launcher's plan (``adaprox_resident_pd_plan``) for the same arguments as
    ``k6d_plan``, in its form (None where it refuses the shape); the card's tests hold the
    two equal."""
    out = (ctypes.c_longlong * len(K6D_PLAN_KEYS))()
    if _library().adaprox_resident_pd_plan(n, d, int(factored), itemsize, sms, out):
        return None
    plan = dict(zip(K6D_PLAN_KEYS, (int(v) for v in out)))
    plan["route"] = K6D_ROUTES[plan["route"]]
    plan["x_shared"], plan["acc_shared"] = bool(plan["x_shared"]), bool(plan["acc_shared"])
    return plan


# the cores of csrc/resident_dsvm_grid.cu, in the order of its core argument
GRID_CORES = ("adapdm", "mp")
# what adaprox_resident_dsvm_plan returns, in its order
PLAN_KEYS = ("cluster", "clusters", "smem_bytes", "rows_per_cta", "rows_held", "fits")


def _grid_plan(lib, core, q, factored, vec, rows):
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    n = q.shape[0]
    err = lib.adaprox_resident_dsvm_plan(n, q.shape[1], int(factored),
                                         int(q.dtype == torch.bfloat16), vec,
                                         GRID_CORES.index(core), int(rows), out)
    _raise_on(err, "dsvm_grid_plan", lib.adaprox_resident_dsvm_error_string)
    plan = dict(zip(PLAN_KEYS, (int(v) for v in out)))
    plan["fits"] = bool(plan["fits"])
    plan["whole"] = plan["fits"] and plan["rows_held"] == plan["rows_per_cta"]
    return plan


def dsvm_grid_plan(q, core, rows, factored=False):
    """How K6a/K6b (``core`` "adapdm") and K6c ("mp") lay out a launch of ``rows`` values
    of t over Q (N, N) or, factored, B (N, d) on the card: the cluster size C (picked from
    the shape and the storage alone), the clusters the launch runs at once, the dynamic
    shared memory of a CTA in bytes, the rows of Q (or B) a CTA owns and those it holds in
    shared memory (the rest it reads from device memory in every pass), ``fits`` (False:
    the vectors do not fit a CTA's shared memory, and a launch is refused) and ``whole``
    (every row of Q in shared memory)."""
    with torch.cuda.device(q.device):
        return _grid_plan(_grid_library(), core, q, factored, _row_vec(q), rows)


def _grid_launch(what, core, q, labels, n_true, big_c, factored, ts, p1, p2, exact, tol, maxit,
                 record):
    """One launch of ``core``'s kernel over the couplings ``ts`` (a float64 host tensor): K6b
    or K6c, and K6a at one row. Returns (x_out (T, n), stats (T, 4), hist (T, 2 or 5,
    hist_len) or None)."""
    vec = _storage(what, q, labels)
    lib = _grid_library()
    dev = q.device
    n = q.shape[0]
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        ts_d = ts.to(**f32)
        count = ts_d.numel()
        plan = _grid_plan(lib, core, q, factored, vec, count)
        if not plan["fits"]:
            raise ValueError(f"{what}: the cluster layout is refused at {tuple(q.shape)}"
                             f"{' (factored)' if factored else ''}: a CTA's vectors do not fit "
                             "its shared memory")
        counter = torch.zeros(1, dtype=torch.int32, device=dev)  # the next row
        x_out, stats = torch.empty((count, n), **f32), torch.empty((count, 4), **f32)
        hist_rows = 5 if core == "mp" else 2
        hist = torch.empty((count, hist_rows, hist_len(maxit)), **f32) if record else None
        err = lib.adaprox_resident_dsvm_rows(
            q.data_ptr(), int(q.dtype == torch.bfloat16), vec, int(factored), n, q.shape[1],
            labels.data_ptr(), n_true, float(big_c), GRID_CORES.index(core), counter.data_ptr(),
            ts_d.data_ptr(), count, float(p1), float(p2), int(exact), float(tol), maxit,
            int(record), x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, f"{what} launch", lib.adaprox_resident_dsvm_error_string)
    return x_out, stats, hist


def _device(what, q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU (plain version) or CUDA tensors, not {q.device}")
    return q.device.type == "cuda"


def resident_adapdm_dsvm(q, labels, big_c, t, norm_a, tol, maxit, n_true=None):
    """Whole-solve AdaPDM for the dual SVM in one kernel launch: min 0.5 x'Qx -
    1'x over 0 <= x <= big_c with labels'x = 0 through the scalar dual, from
    x0 = 0, y0 = 0 and gamma0 = 1/(2 Theta t norm_a), Theta = 1.2. ``q`` (N, N)
    symmetric (dense only, as in the JAX package), ``labels`` (N,); pass the
    unpadded point count of a zero-padded Q as ``n_true``. ``t`` and
    ``norm_a`` must be positive (checked before anything runs).

    Returns (x, numit, norm_res, converged) as tensors on the input's device.
    CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K6a, the AdaPDM core of ``csrc/resident_dsvm_grid.cu`` over one row: ``q``
    f32 or bf16, ``labels`` f32, both contiguous; each launch adds one to
    ``resident_adapdm_dsvm.launches``."""
    validate_positive(t=t, norm_a=norm_a)
    if not _device("K6a", q):
        return resident_adapdm_dsvm_plain(q, labels, big_c, t, norm_a, tol, maxit, n_true)
    n_true = _check("resident_adapdm_dsvm", q, labels, maxit, n_true, False)
    x, stats, _ = _grid_launch("K6a", "adapdm", q, labels, n_true, big_c, False,
                               _ts([t], torch.float64), norm_a, THETA, False, tol, int(maxit),
                               False)
    resident_adapdm_dsvm.launches += 1
    return x[0], stats[0, 0].to(torch.int32), stats[0, 1], stats[0, 3] > 0


resident_adapdm_dsvm.launches = 0


def resident_adapdm_dsvm_sweep(q, labels, big_c, ts, norm_a, tol, maxit, n_true=None,
                               record=False, factored=False):
    """The coupling sweep (dual_svm/runme.jl:61) as ONE kernel launch: a whole
    early-exit AdaPDM solve (``resident_adapdm_dsvm``) for each value of
    ``ts`` (on the card at once, each on a cluster of its own). With
    ``factored=True`` ``q`` is B (N, d), B = D_y X, and the gradient runs
    gram-free as B (B'x) - 1. ``norm_a`` must be positive.

    Returns (x (T, N), numit (T,), norm_res (T,), converged (T,)), plus the
    (gamma_hist, norm_res_hist) of shape (T, maxit) when ``record=True`` (zero
    past numit); ``resident_pd_records`` turns a row into ``Records``.
    CPU tensors take the plain version. CUDA tensors launch K6b, the AdaPDM
    core of ``csrc/resident_dsvm_grid.cu``, with what K6a takes; each launch
    adds one to ``resident_adapdm_dsvm_sweep.launches``. Every row equals a
    one-row launch with its t bit for bit (a dense row is its K6a launch)."""
    validate_positive(norm_a=norm_a)
    if not _device("K6b", q):
        return resident_adapdm_dsvm_sweep_plain(q, labels, big_c, ts, norm_a, tol, maxit,
                                                n_true, record, factored)
    n_true = _check("resident_adapdm_dsvm_sweep", q, labels, maxit, n_true, factored)
    maxit = int(maxit)
    x, stats, hist = _grid_launch("K6b", "adapdm", q, labels, n_true, big_c, factored,
                                  _ts(ts, torch.float64), norm_a, THETA, False, tol, maxit,
                                  record)
    resident_adapdm_dsvm_sweep.launches += 1
    base = (x, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 3] > 0)
    if record:
        return base + (hist[:, 0, :maxit], hist[:, 1, :maxit])
    return base


resident_adapdm_dsvm_sweep.launches = 0


def resident_cv_dsvm(q, labels, big_c, gamma, sigma, tol, maxit, n_true=None, record=False,
                     factored=False):
    """Whole-solve Condat-Vu for the dual SVM in one kernel launch, with the
    fixed steps (gamma, sigma) (the engine's par heuristics,
    ``solvers.primal_dual.condat_vu_steps``), dense Q or factored B as the
    sweep takes them.

    Returns (x, numit, norm_res, converged), plus ((norm_res_hist,
    objective_hist),) of shape (maxit,) when ``record=True`` (zero past
    numit); ``resident_cv_records`` turns them into ``Records``. CPU tensors
    take the plain version. CUDA tensors launch K6d (``csrc/resident_pd.cu``, its
    layout ``k6d_plan``'s), with what K6a takes (factored, d at most K6D_MAX_D);
    each launch adds one to ``resident_cv_dsvm.launches``."""
    if not _device("K6d", q):
        return resident_cv_dsvm_plain(q, labels, big_c, gamma, sigma, tol, maxit, n_true,
                                      record, factored)
    n_true = _check("resident_cv_dsvm", q, labels, maxit, n_true, factored)
    maxit = int(maxit)
    x, stats, hist = _launch("K6d", q, labels, n_true, big_c, factored, maxit, record, gamma,
                             sigma, tol)
    resident_cv_dsvm.launches += 1
    base = (x[0], stats[0, 0].to(torch.int32), stats[0, 1], stats[0, 2] > 0)
    if record:
        return base + ((hist[0, 0, :maxit], hist[0, 1, :maxit]),)
    return base


resident_cv_dsvm.launches = 0


# -- records ----------------------------------------------------------------------------


def resident_pd_records(numit, gamma_hist, res_hist, *, maxit, t):
    """``Records`` of a resident AdaPDM row: sigma = gamma t^2 from the
    coupling, the counters from the engine's deterministic schedule at the
    record snapshot (the warm-up adds one f/grad/A evaluation; every
    iteration one each of f, grad, prox_g, prox_h, A, At). Rows past
    ``numit`` are masked out by ``valid``."""
    dev = gamma_hist.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    return Records(it=it, gamma=gamma_hist,
                   sigma=gamma_hist * torch.as_tensor(t, dtype=gamma_hist.dtype) ** 2,
                   norm_res=res_hist, objective=torch.zeros_like(gamma_hist), f_evals=it + 1,
                   grad_f_evals=it + 1, prox_g_evals=it, prox_h_evals=it, A_evals=it + 1,
                   At_evals=it, valid=it <= torch.as_tensor(numit, device=dev))


def resident_cv_records(numit, gamma, sigma, hists, *, maxit):
    """``Records`` of a resident Condat-Vu solve: the fixed (gamma, sigma), the
    histories (norm_res, objective), the engine's counters at the record
    snapshot (A/f/grad = it+1, prox_h = it, At/prox_g = it)."""
    hr, ho = hists
    dev = hr.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    return Records(it=it, gamma=torch.full_like(hr, float(gamma)),
                   sigma=torch.full_like(hr, float(sigma)), norm_res=hr, objective=ho,
                   f_evals=it + 1, grad_f_evals=it + 1, prox_g_evals=it, prox_h_evals=it,
                   A_evals=it + 1, At_evals=it, valid=it <= torch.as_tensor(numit, device=dev))
