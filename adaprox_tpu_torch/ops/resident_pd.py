"""K6a, K6b and K6d, the whole-solve primal-dual kernels of the dual SVM:
min 0.5 x'Qx - 1'x over 0 <= x <= C with labels'x = 0, as f = 0.5 x'Qx - 1'x,
g = IndBox(0, C), h = IndZero and A = labels' (the dual variable is a scalar).

Counterpart of ``adaprox_tpu/ops/resident.py:765-1517, 2134``:
``resident_adapdm_dsvm`` (K6a, one AdaPDM solve, dense Q, core ``_pd_core``),
``resident_adapdm_dsvm_sweep`` (K6b, the coupling-t sweep, dense Q or factored
B with Q = B B'), ``resident_cv_dsvm`` (K6d, one Condat-Vu solve with fixed
steps, core ``_dsvm_cv_core``) and the records ``resident_pd_records`` /
``resident_cv_records``. Here the three entries reach one hand-written CUDA
C++ routine for Hopper (``csrc/resident_pd.cu``): one cooperative launch with
grid-wide barriers between the phases of an iteration, built with nvcc for
``sm_90a`` at first use and loaded with ctypes, as K2 (``ops/resident.py``).

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
           "resident_pd_records", "resident_cv_records", "hist_len", "build_library"]

SOURCE = kernels._PKG / "csrc" / "resident_pd.cu"
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


# -- the CUDA kernel --------------------------------------------------------------------


def build_library():
    """Compile ``csrc/resident_pd.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # q .. part_len, the leading arguments of the three entries
    problem = [p, i, i, i, ll, ll, p, i, f, p, p, p, p, ll]
    tail = [i, i, p, p, p, p]  # maxit, record, x_out, stats, hist, stream
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_resident_pd_parts": ([], i),
        "adaprox_resident_pd": (problem + [f, f, f, f] + tail, i),
        "adaprox_resident_pd_sweep": (problem + [p, i, f, f, f] + tail, i),
        "adaprox_resident_cv": (problem + [f, f, f] + tail, i),
        "adaprox_resident_pd_error_string": ([i], ctypes.c_char_p)})


def _problem(lib, what, q, labels, n_true, big_c, factored):
    """Check what the kernel takes and make the scratch of one launch. Returns
    the leading arguments of the C entries and the tensors behind them."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} stores Q (or B) as float32 or bfloat16 on CUDA, got {q.dtype}")
    if labels.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 labels on CUDA, got {labels.dtype}")
    if not (q.is_contiguous() and labels.is_contiguous()):
        raise ValueError(f"{what} needs contiguous q and labels")
    n = q.shape[0]
    d = q.shape[1] if factored else 0
    row = d if factored else n
    vec = 8 if q.dtype == torch.bfloat16 else 4
    if row % vec or q.data_ptr() % 16:
        vec = 1
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    xs, grad, v = torch.empty((2, n), **f32), torch.empty(n, **f32), torch.empty(n, **f32)
    # the launcher sizes the grid, at most one CTA per SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.empty((lib.adaprox_resident_pd_parts() + d) * sms, **f32)
    args = [q.data_ptr(), int(q.dtype == torch.bfloat16), vec, int(factored), n, d,
            labels.data_ptr(), n_true, float(big_c), xs.data_ptr(), grad.data_ptr(),
            v.data_ptr(), part.data_ptr(), part.numel()]
    return args, (xs, grad, v, part)


def _raise_on(lib, err, what):
    if err:
        msg = lib.adaprox_resident_pd_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _launch(what, entry, q, labels, n_true, big_c, factored, rows, stats_w, maxit, record,
            scalars):
    """One launch of ``entry`` with its ``scalars`` (the arguments between
    part_len and maxit). Returns (x_out (rows, n), stats (rows, stats_w),
    hist (rows, 2, hist_len) or None)."""
    lib = _library()
    dev = q.device
    n = q.shape[0]
    with torch.cuda.device(dev):
        # keep: the tensors behind args
        args, keep = _problem(lib, what, q, labels, n_true, big_c, factored)
        f32 = dict(dtype=torch.float32, device=dev)
        x_out, stats = torch.empty((rows, n), **f32), torch.empty((rows, stats_w), **f32)
        hist = torch.empty((rows, 2, hist_len(maxit)), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*args, *scalars, maxit, int(record), x_out.data_ptr(),
                                  stats.data_ptr(), hist.data_ptr() if record and maxit else None,
                                  stream)
    _raise_on(lib, err, f"{what} launch")
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
    K6a (``csrc/resident_pd.cu``): ``q`` f32 or bf16, ``labels`` f32, both
    contiguous; each launch adds one to ``resident_adapdm_dsvm.launches``."""
    validate_positive(t=t, norm_a=norm_a)
    if not _device("K6a", q):
        return resident_adapdm_dsvm_plain(q, labels, big_c, t, norm_a, tol, maxit, n_true)
    n_true = _check("resident_adapdm_dsvm", q, labels, maxit, n_true, False)
    x, stats, _ = _launch("K6a", "adaprox_resident_pd", q, labels, n_true, big_c, False, 1, 4,
                          int(maxit), False, [float(t), float(norm_a), THETA, float(tol)])
    resident_adapdm_dsvm.launches += 1
    return x[0], stats[0, 0].to(torch.int32), stats[0, 1], stats[0, 3] > 0


resident_adapdm_dsvm.launches = 0


def resident_adapdm_dsvm_sweep(q, labels, big_c, ts, norm_a, tol, maxit, n_true=None,
                               record=False, factored=False):
    """The coupling sweep (dual_svm/runme.jl:61) as ONE kernel launch: a whole
    early-exit AdaPDM solve (``resident_adapdm_dsvm``) for each value of
    ``ts``, one after another. With ``factored=True`` ``q`` is B (N, d), B =
    D_y X, and the gradient runs gram-free as B (B'x) - 1. ``norm_a`` must be
    positive.

    Returns (x (T, N), numit (T,), norm_res (T,), converged (T,)), plus the
    (gamma_hist, norm_res_hist) of shape (T, maxit) when ``record=True`` (zero
    past numit); ``resident_pd_records`` turns a row into ``Records``.
    CPU tensors take the plain version. CUDA tensors launch K6b, with what
    K6a takes; each launch adds one to
    ``resident_adapdm_dsvm_sweep.launches``. A dense row equals
    ``resident_adapdm_dsvm`` with its t bit for bit."""
    validate_positive(norm_a=norm_a)
    if not _device("K6b", q):
        return resident_adapdm_dsvm_sweep_plain(q, labels, big_c, ts, norm_a, tol, maxit,
                                                n_true, record, factored)
    n_true = _check("resident_adapdm_dsvm_sweep", q, labels, maxit, n_true, factored)
    ts_d = _ts(ts, torch.float32).to(q.device)
    count, maxit = ts_d.numel(), int(maxit)
    x, stats, hist = _launch("K6b", "adaprox_resident_pd_sweep", q, labels, n_true, big_c,
                             factored, count, 4, maxit, record,
                             [ts_d.data_ptr(), count, float(norm_a), THETA, float(tol)])
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
    take the plain version. CUDA tensors launch K6d, with what K6a takes; each
    launch adds one to ``resident_cv_dsvm.launches``."""
    if not _device("K6d", q):
        return resident_cv_dsvm_plain(q, labels, big_c, gamma, sigma, tol, maxit, n_true,
                                      record, factored)
    n_true = _check("resident_cv_dsvm", q, labels, maxit, n_true, factored)
    maxit = int(maxit)
    x, stats, hist = _launch("K6d", "adaprox_resident_cv", q, labels, n_true, big_c, factored,
                             1, 3, maxit, record, [float(gamma), float(sigma), float(tol)])
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
