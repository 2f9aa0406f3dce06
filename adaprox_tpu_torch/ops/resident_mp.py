"""K6c, the whole-solve Malitsky-Pock t-sweep of the dual SVM: min 0.5 x'Qx - 1'x
over 0 <= x <= C with labels'x = 0, as f = 0.5 x'Qx - 1'x, g = IndBox(0, C),
h = IndZero and A = labels' (the dual variable is a scalar), with the
linesearch on the device.

Counterpart of ``adaprox_tpu/ops/resident.py:956-1250, 2106``:
``resident_mp_dsvm_sweep`` (K6c, ``_resident_mp_dsvm_sweep_jit`` over
``_dsvm_mp_core``, dense Q or factored B with Q = B B') and its records
``resident_mp_records``. Here the entry launches the Malitsky-Pock core of a
hand-written CUDA C++ kernel for Hopper (``csrc/resident_dsvm_grid.cu``, which
K6a and K6b share with their AdaPDM core; ``ops/resident_pd.py`` builds and
launches it): one launch for the whole sweep, each value of t a whole solve on
its own thread-block cluster, the rows at once.

The entry dispatches on where its tensors lie: CPU tensors take the plain
version ``resident_mp_dsvm_sweep_plain`` (a Python loop over the same
iteration, the acceptance test read on the host each trial); CUDA tensors
launch the kernel or raise. Q (or B) may be stored bf16; the iterates and
scalars follow ``labels``' dtype. ``n_true`` is the unpadded point count of a
zero-padded problem: the linear term is masked to the first ``n_true``
coordinates, so the padded ones stay exactly 0.
"""

from __future__ import annotations

import torch

from ..solvers.common import Records
from ..solvers.rules import validate_positive
from .resident_pd import (_check, _clamp, _device, _dsvm_obj, _grid_launch, _scalars, _stats,
                          _ts, hist_len)

__all__ = ["resident_mp_dsvm_sweep", "resident_mp_dsvm_sweep_plain", "resident_mp_records"]

# the initial trial and up to 100 halvings (the engine's _MAX_TRIALS = 100)
MAX_TRIALS = 101


def _mp_core_plain(q, lab, t, sigma0, big_c, tol, n_true, *, maxit, record, factored,
                   exact_bregman):
    """``_dsvm_mp_core`` line by line. Returns (x, it, norm_res, conv, ls_failed,
    hists) with the five histories (gamma, sigma, norm_res, trials, f) of
    length hist_len(maxit), or None."""
    dt, dev = lab.dtype, lab.device
    qx_of, ones, a_mv = _dsvm_obj(q, lab, n_true, factored)
    t, sigma, big_c, tol, zero = _scalars(dt, dev, t, sigma0, big_c, tol, 0.0)
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dt, device=dev))
    n = q.shape[0]
    # the start: x0 = 0, so Q x0 = 0 and f(0) = 0 (no matvec); y0 = 0
    x = torch.zeros(n, dtype=dt, device=dev)
    qx, at_y = torch.zeros_like(x), torch.zeros_like(x)
    y = a_x = f_x = torch.zeros((), dtype=dt, device=dev)
    norm_res = torch.full((), torch.inf, dtype=dt, device=dev)
    hl = hist_len(maxit)
    hists = torch.zeros((5, hl), dtype=dt, device=dev) if record else None
    ls_failed = False
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        at_y_prev = at_y
        y = y + sigma * a_x  # w; prox of (IndZero)* = Zero: the identity
        at_y = lab * y
        sigma_prev = sigma
        x_prev, a_x_prev, qx_prev, f_prev = x, a_x, qx, f_x
        grad_prev = qx_prev - ones  # the accepted trial's Q x: no matvec here
        s, trials = sigma * sqrt2, 1
        while True:
            theta = s / sigma_prev
            gamma = t * t * s
            at_ybar = (1 + theta) * at_y - theta * at_y_prev
            v = x_prev - gamma * (at_ybar + grad_prev)
            x = _clamp(v, zero, big_c)
            a_x = a_mv(x)
            qx = qx_of(x)
            f_x = 0.5 * torch.sum(x * qx) - torch.sum(ones * x)
            dax = a_x - a_x_prev
            dx = x - x_prev
            if exact_bregman:
                # f(x) - f(x_prev) - <grad_prev, dx> = 0.5 <dx, qx - qx_prev>, >= 0
                breg = torch.maximum(0.5 * torch.sum(dx * (qx - qx_prev)), zero)
            else:
                breg = f_x - f_prev - torch.sum(grad_prev * dx)
            lhs = gamma * s * dax * dax + 2 * gamma * breg
            failed = bool(lhs > 0.95 * torch.sum(dx * dx))  # the host sync of each trial
            if not (failed and trials < MAX_TRIALS):
                break
            s, trials = s / 2, trials + 1
        ls_failed = ls_failed or failed
        primal = (v - x) / gamma + (qx - ones) + at_y
        # dual_res = (w - y) / sigma_prev - a_x = -a_x
        norm_res = torch.sqrt(torch.sum(primal * primal) + a_x * a_x)
        if record:
            hists[:, it] = torch.stack([gamma, s, norm_res, torch.tensor(float(trials), dtype=dt, device=dev),
                                        f_x])
        sigma = s
        it += 1
    return x, it, norm_res, norm_res <= tol, ls_failed, hists


def resident_mp_dsvm_sweep_plain(q, labels, big_c, ts, sigma0, tol, maxit, n_true=None,
                                 record=False, factored=False, exact_bregman=False):
    """The plain version of K6c: one ``_dsvm_mp_core`` solve a coupling value, in
    order. Returns what ``resident_mp_dsvm_sweep`` returns."""
    validate_positive(sigma0=sigma0)
    n_true = _check("resident_mp_dsvm_sweep", q, labels, maxit, n_true, factored)
    dt, dev = labels.dtype, labels.device
    maxit = int(maxit)
    outs = [_mp_core_plain(q, labels, t, sigma0, big_c, tol, n_true, maxit=maxit, record=record,
                           factored=factored, exact_bregman=bool(exact_bregman))
            for t in _ts(ts, dt).tolist()]
    # the TPU kernel's stats travel as f32
    stats = torch.stack([_stats(dt, dev, o[1], o[2], o[3].to(dt), float(o[4])) for o in outs])
    base = (torch.stack([o[0] for o in outs]), stats[:, 0].to(torch.int32), stats[:, 1].to(dt),
            stats[:, 2] > 0, stats[:, 3] > 0)
    if record:
        hists = torch.stack([o[5] for o in outs])  # (T, 5, hist_len)
        return base + (tuple(hists[:, k, :maxit] for k in range(5)),)
    return base


def resident_mp_dsvm_sweep(q, labels, big_c, ts, sigma0, tol, maxit, n_true=None, record=False,
                           factored=False, exact_bregman=False):
    """The dual-SVM Malitsky-Pock coupling sweep (dual_svm/runme.jl:61) as ONE
    kernel launch: a whole early-exit linesearch solve for each value of
    ``ts``, one after another, from x0 = 0 and y0 = 0 with the first dual step
    ``sigma0`` (positive; checked before anything runs). ``q`` is Q (N, N)
    symmetric, or with ``factored=True`` B (N, d) with Q = B B' (the gradient
    runs gram-free as B (B'x) - 1); ``labels`` (N,); pass the unpadded point
    count of a zero-padded problem as ``n_true``. ``exact_bregman`` takes the
    acceptance test's Bregman term as max(0.5 <dx, Q dx>, 0) from the carried
    Q x instead of the raw objective difference.

    Returns (x (T, N), numit (T,), norm_res (T,), converged (T,), ls_failed
    (T,)), plus the histories (gamma, sigma, norm_res, trials, f) of shape
    (T, maxit) as a tuple when ``record=True`` (zero past numit);
    ``resident_mp_records`` turns a row into ``Records``. CPU tensors take the
    plain version. CUDA tensors launch K6c, the Malitsky-Pock core of
    ``csrc/resident_dsvm_grid.cu`` (the rows at once, each on a cluster of its
    own): ``q`` f32 or bf16, ``labels`` f32, both contiguous; each launch adds
    one to ``resident_mp_dsvm_sweep.launches``. Every row equals a one-row
    sweep with its t bit for bit."""
    validate_positive(sigma0=sigma0)
    if not _device("K6c", q):
        return resident_mp_dsvm_sweep_plain(q, labels, big_c, ts, sigma0, tol, maxit, n_true,
                                            record, factored, exact_bregman)
    n_true = _check("resident_mp_dsvm_sweep", q, labels, maxit, n_true, factored)
    maxit = int(maxit)
    x, stats, hist = _grid_launch("K6c", "mp", q, labels, n_true, big_c, factored,
                                  _ts(ts, torch.float64), sigma0, 0.0, bool(exact_bregman), tol,
                                  maxit, record)
    resident_mp_dsvm_sweep.launches += 1
    base = (x, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 2] > 0, stats[:, 3] > 0)
    if record:
        return base + (tuple(hist[:, k, :maxit] for k in range(5)),)
    return base


resident_mp_dsvm_sweep.launches = 0


# -- records ----------------------------------------------------------------------------


def resident_mp_records(numit, hists, *, maxit):
    """``Records`` of one resident MP row (K6c, or K7a's MP core) from its histories
    (gamma, sigma, norm_res, trials, and f or the f = 0 family's objective). The counters are rebuilt from the trial counts as the
    engine meters them (solvers/malitsky_pock.py): each iteration prox_h and
    At +1, grad_f +2, f_evals 1 + trials, prox_g and A + trials; the start A and
    At +1. Rows past ``numit`` are masked out by ``valid``."""
    hg, hs, hr, ht, ho = hists
    dev = hg.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    cum_t = torch.cumsum(ht.to(torch.int64), 0)
    return Records(it=it, gamma=hg, sigma=hs, norm_res=hr, objective=ho, f_evals=it + cum_t,
                   grad_f_evals=2 * it, prox_g_evals=cum_t, prox_h_evals=it, A_evals=1 + cum_t,
                   At_evals=1 + it, valid=it <= torch.as_tensor(numit, device=dev))
