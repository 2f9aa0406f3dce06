"""K4 and K4b, the backtracking whole-solve kernels: backtracking proximal
gradient (with the per-iteration step inflation xi) and backtracking Nesterov
of f(x) + g(x) in one launch, for every ``obj_kind`` of K2 ("ls", "logreg",
"cubic") and every prox kind of its menu; and K4's aGRAAL core, a whole
aGRAAL solve in one launch, for the same objectives and prox kinds.

Counterpart of ``adaprox_tpu/ops/resident_bt.py``. For its backtracking core
``_bt_core``: ``resident_backtracking`` (K4, one solve) and
``resident_bt_sweep`` (K4b, the backtracking rows of a method menu in one
launch, each row with its own gamma0, xi and momentum flag, always in record
mode). The trial loop runs on the device: at most 101 evaluations an
iteration, the failure of a capped backtrack latched into ``ls_failed``, and
with ``exact_bregman`` (least squares only) the sufficient-descent test
through 0.5 ||res_z - res_x||^2 instead of the raw objective difference. For
its aGRAAL core ``_agraal_core``: ``resident_agraal`` (the golden-ratio
average, the inverse-cocoercivity step and, for ``gamma0 <= 0``, the secant
gamma0 computed on the device) and ``resident_agraal_records``.

Here the kernels are hand-written CUDA C++ for Hopper, on the P1 phase,
gradient loop and objective switch that K2 shares through
``csrc/resident_common.cuh``: K4 and K4b in ``csrc/resident_bt.cu``, aGRAAL
in ``csrc/resident_agraal.cu``. Each is one cooperative launch with grid-wide
barriers between its phases, built with nvcc for ``sm_90a`` at first use and
loaded with ctypes. K4 and K4b run one device routine on K2's grid: a trial is
one phase with one grid sync (its point formed inside the pass over A), and
K4b runs its rows in lockstep groups (``k4b_plan``), each pass over A and
each grid sync shared by the rows of a group; each row keeps K4's order of
every sum, so a sweep row equals the single solve with its arguments bit for
bit. ``k4b_syncs`` counts the grid syncs a launch takes from its records.

Every entry dispatches on where its tensors lie: CPU tensors take the plain
versions ``resident_backtracking_plain`` / ``resident_bt_sweep_plain`` /
``resident_agraal_plain`` (Python loops over the same iteration); CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..solvers.common import Records
from . import kernels
from .resident import _GVAL, _PROX, _PROX_IDX, _check_menu, _obj_split, _problem, _transposed

__all__ = ["resident_backtracking", "resident_backtracking_plain", "resident_bt_sweep",
           "resident_bt_sweep_plain", "resident_bt_records", "resident_agraal",
           "resident_agraal_plain", "resident_agraal_records", "build_library",
           "build_agraal_library", "k4b_plan", "k4b_syncs"]

SOURCE = kernels._PKG / "csrc" / "resident_bt.cu"
AGRAAL_SOURCE = kernels._PKG / "csrc" / "resident_agraal.cu"
# as K2's: every elementwise expression rounds after each operation
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)

# the initial trial and up to 100 shrinks: 101 prox/f evaluations an iteration
_MAX_EVALS = 101


def _bt_plain(a, b, x0, gamma0, xi, shrink, tol, maxit, prox_kind, p1, p2, cube_c, nesterov,
              obj_kind, m_true, record, exact_bregman):
    """``_bt_core`` line by line. The trial step is gamma * xi: the single
    entry passes xi = 1 for Nesterov, as the JAX kernel does, and the sweep
    passes each row's own xi (its "dynamic" post-step)."""
    dt, dev = x0.dtype, x0.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    gamma0, xi, shrink, tol, p1, p2, cube_c = (
        scalar(v) for v in (gamma0, xi, shrink, tol, p1, p2, cube_c))
    at = _transposed(a, obj_kind, m_true).to(dt)
    a, b = a.to(dt), b.to(dt)
    val_aux_of, grad_from_aux = _obj_split(a, at, b, obj_kind, m_true, cube_c)
    prox_fn, gval_fn = _PROX[prox_kind], _GVAL[prox_kind]
    # only the least-squares aux (the residual) gives the exact Bregman form
    exact = bool(exact_bregman) and obj_kind == "ls"
    hists = torch.zeros((4, maxit), dtype=dt, device=dev)

    f_x, aux_x = val_aux_of(x0)
    grad_x = grad_from_aux(aux_x)
    x = z = x0
    gamma, theta, norm_res = gamma0, scalar(1.0), scalar(math.inf)
    it, ls_failed = 0, False

    def violates(gamma, z_t, f_z, aux):
        dz = z_t - x
        if exact:
            dres = aux - aux_x
            return bool(0.5 * torch.sum(dres * dres) > torch.sum(dz * dz) / (2 * gamma))
        return bool(f_z > f_x + torch.sum(grad_x * dz) + torch.sum(dz * dz) / (2 * gamma))

    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        trial_gamma = gamma * xi
        evals = 1
        z_t = prox_fn(x - trial_gamma * grad_x, trial_gamma, p1, p2)
        f_z, aux = val_aux_of(z_t)
        bad = violates(trial_gamma, z_t, f_z, aux)  # a NaN f_z passes
        while bad and evals < _MAX_EVALS:
            trial_gamma = trial_gamma * shrink
            evals += 1
            z_t = prox_fn(x - trial_gamma * grad_x, trial_gamma, p1, p2)
            f_z, aux = val_aux_of(z_t)
            bad = violates(trial_gamma, z_t, f_z, aux)
        gamma = trial_gamma
        dz = z_t - x
        norm_res = torch.sqrt(torch.sum(dz * dz)) / gamma
        if record:
            hists[:, it] = torch.stack([gamma, norm_res, f_z + gval_fn(z_t, p1, p2),
                                        scalar(evals)])
        it += 1
        ls_failed = ls_failed or bad
        if it < maxit and bool(norm_res > tol):  # the post-step feeds the next iteration only
            if nesterov:
                theta_next = (1 + torch.sqrt(1 + 4 * theta * theta)) / 2
                x = z_t + ((theta - 1) / theta_next) * (z_t - z)
                theta = theta_next
                f_x, aux_x = val_aux_of(x)
            else:
                x, f_x, aux_x = z_t, f_z, aux
            grad_x = grad_from_aux(aux_x)
        z = z_t
    conv = norm_res <= tol
    # the TPU kernel's stats travel as f32: numit and norm_res round through it
    stats = torch.stack([scalar(it), norm_res, gamma, conv.to(dt),
                         scalar(float(ls_failed))]).to(torch.float32)
    base = (z, stats[0].to(torch.int32), stats[1].to(dt), stats[3] > 0, stats[4] > 0)
    return base + tuple(hists) if record else base


def resident_backtracking_plain(a, b, x0, gamma0, tol, maxit, *, xi=1.0, shrink=0.5,
                                prox_kind="l1", p1=0.0, p2=0.0, cube_c=0.0, nesterov=False,
                                obj_kind="ls", m_true=None, record=False,
                                exact_bregman=False):
    """The plain PyTorch version of K4: ``_bt_core``'s loop, one
    host-checked trial at a time. Scalars are 0-d tensors in the iterate
    dtype; bf16 storage of ``a`` is upcast to it (for "logreg" after A^T is
    divided by the mean's divisor in storage dtype, as the kernel's wrapper
    does). Nesterov takes no inflation (xi is ignored). Returns what
    ``resident_backtracking`` returns."""
    return _bt_plain(a, b, x0, gamma0, 1.0 if nesterov else xi, shrink, tol, maxit, prox_kind,
                     p1, p2, cube_c, bool(nesterov), obj_kind, m_true, record, exact_bregman)


def _bt_rows(rows, dtype):
    """The rows table in the iterate dtype on the host, as the JAX sweep casts
    it, after checking it: the CUDA kernel reads three values a row, so a
    table of another width, or an empty one, is refused, and so is a
    momentum flag outside {0, 1}."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows))
    rows = rows.to(device="cpu", dtype=dtype)
    if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != 3:
        raise ValueError(f"rows must be (R >= 1, 3) [gamma0, xi, nesterov_flag], got "
                         f"{tuple(rows.shape)}")
    flag = rows[:, 2]
    if not bool(((flag == 0) | (flag == 1)).all()):
        raise ValueError(f"every row's nesterov_flag must be 0 or 1, got {flag.tolist()}")
    return rows


def resident_bt_sweep_plain(a, b, x0, rows, tol, maxit, *, shrink=0.5, prox_kind="l1", p1=0.0,
                            p2=0.0, cube_c=0.0, obj_kind="ls", m_true=None,
                            exact_bregman=False):
    """The plain version of the sweep: one plain solve a row, with that row's
    gamma0, xi and momentum flag (the trial step is gamma * xi for every
    row), in record mode. Returns what ``resident_bt_sweep`` returns."""
    rows = _bt_rows(rows, x0.dtype)
    outs = [_bt_plain(a, b, x0, g0, xi, shrink, tol, maxit, prox_kind, p1, p2, cube_c,
                      flag > 0, obj_kind, m_true, True, exact_bregman)
            for g0, xi, flag in rows.tolist()]
    return (tuple(torch.stack([o[k] for o in outs]) for k in range(5))
            + (tuple(torch.stack([o[k] for o in outs]) for k in range(5, 9)),))


def resident_bt_records(numit, gamma_hist, res_hist, obj_hist, trials_hist, *, maxit,
                        nesterov=False):
    """``Records`` from the record-mode histories. The counters follow from
    the trial counts as the engine meters them at its record: one f and one
    gradient at the start; each iteration's backtrack costs its trials in
    prox_g and f; after the record PG finishes the pullback (gradient + 1)
    and Nesterov evaluates the momentum point (f + 1, gradient + 1). So at
    iteration ``it``: f_evals = 1 + sum(trials) (+ it - 1 for Nesterov),
    grad_f_evals = it, prox_g_evals = sum(trials). Rows past ``numit`` are
    masked out by ``valid``."""
    dev = gamma_hist.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    z = torch.zeros(maxit, dtype=torch.int64, device=dev)
    cum_t = torch.cumsum(trials_hist.to(torch.int64), 0)
    f_evals = 1 + cum_t + (it - 1 if nesterov else 0)
    return Records(it=it, gamma=gamma_hist, sigma=torch.zeros_like(gamma_hist),
                   norm_res=res_hist, objective=obj_hist, f_evals=f_evals, grad_f_evals=it,
                   prox_g_evals=cum_t, prox_h_evals=z, A_evals=z, At_evals=z,
                   valid=it <= torch.as_tensor(numit, device=dev))


def resident_agraal_plain(a, b, x1, x0, gamma0, tol, maxit, *, gamma_max=1e6, phi=1.5,
                          prox_kind="l1", p1=0.0, p2=0.0, cube_c=0.0, obj_kind="ls", m_true=None,
                          record=False):
    """The plain PyTorch version of K4's aGRAAL core: ``_agraal_core`` line
    by line, one host-checked iteration at a time. Scalars are 0-d tensors
    in the iterate dtype; bf16 storage of ``a`` is upcast to it (for "logreg"
    after A^T is divided by the mean's divisor in storage dtype, as the
    kernel's wrapper does). Returns what ``resident_agraal`` returns."""
    dt, dev = x1.dtype, x1.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    gamma0, gamma_max, phi, tol, p1, p2, cube_c = (
        scalar(v) for v in (gamma0, gamma_max, phi, tol, p1, p2, cube_c))
    at = _transposed(a, obj_kind, m_true).to(dt)
    a, b = a.to(dt), b.to(dt)
    val_aux_of, grad_from_aux = _obj_split(a, at, b, obj_kind, m_true, cube_c)
    prox_fn, gval_fn = _PROX[prox_kind], _GVAL[prox_kind]
    hists = torch.zeros((3, maxit), dtype=dt, device=dev)
    rho = 1 / phi + 1 / (phi * phi)

    grad_x = grad_from_aux(val_aux_of(x1)[1])
    grad_prev = grad_from_aux(val_aux_of(x0)[1])
    dx0, dg0 = x1 - x0, grad_x - grad_prev
    secant = torch.sqrt(torch.sum(dx0 * dx0)) / torch.sqrt(torch.sum(dg0 * dg0))
    gamma = torch.where(gamma0 > 0, gamma0, secant)
    x, x_prev, x_bar = x1, x0, x1
    theta, norm_res = scalar(1.0), scalar(math.inf)
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        # identical iterates give 0/0 = NaN: taken as +inf (engine semantics)
        dx, dg = x - x_prev, grad_x - grad_prev
        curv = torch.sum(dx * dx) / torch.sum(dg * dg)
        curv = torch.where(torch.isnan(curv), scalar(math.inf), curv)
        gamma_new = torch.minimum(torch.minimum(rho * gamma, phi * theta * curv / (4 * gamma)),
                                  gamma_max)
        theta = phi * gamma_new / gamma
        gamma = gamma_new
        x_bar = ((phi - 1) * x + x_bar) / phi
        x_new = prox_fn(x_bar - gamma * grad_x, gamma, p1, p2)
        dxn = x_new - x
        norm_res = torch.sqrt(torch.sum(dxn * dxn)) / gamma
        if record:
            # the objective at the NEW prox point, as the engine records it
            objective = val_aux_of(x_new)[0] + gval_fn(x_new, p1, p2)
            hists[:, it] = torch.stack([gamma, norm_res, objective])
        it += 1
        if it < maxit and bool(norm_res > tol):  # the gradient feeds the next iteration only
            x_prev, grad_prev = x, grad_x
            grad_x = grad_from_aux(val_aux_of(x_new)[1])
        x = x_new
    conv = norm_res <= tol
    # the TPU kernel's stats travel as f32: numit and norm_res round through it
    stats = torch.stack([scalar(it), norm_res, gamma, conv.to(dt)]).to(torch.float32)
    base = (x, stats[0].to(torch.int32), stats[1].to(dt), stats[3] > 0)
    return base + tuple(hists) if record else base


def resident_agraal_records(numit, gamma_hist, res_hist, obj_hist, *, maxit):
    """``Records`` from the record-mode histories of ``resident_agraal``. The
    counters are deterministic, as the engine meters them at its record: two
    f and gradient evaluations at the start (both companion points), then per
    iteration one prox before the record and one f and gradient after it. So
    at iteration ``it``: f_evals = grad_f_evals = it + 1, prox_g_evals = it.
    Rows past ``numit`` are masked out by ``valid``."""
    dev = gamma_hist.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    z = torch.zeros(maxit, dtype=torch.int64, device=dev)
    return Records(it=it, gamma=gamma_hist, sigma=torch.zeros_like(gamma_hist),
                   norm_res=res_hist, objective=obj_hist, f_evals=it + 1, grad_f_evals=it + 1,
                   prox_g_evals=it, prox_h_evals=z, A_evals=z, At_evals=z,
                   valid=it <= torch.as_tensor(numit, device=dev))


def build_library():
    """Compile ``csrc/resident_bt.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def build_agraal_library():
    """Compile ``csrc/resident_agraal.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(AGRAAL_SOURCE, NVCC_FLAGS)


def _library(source=SOURCE):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # obj_kind .. part_len, the leading arguments of both entries (as K2's)
    problem = [i, f, f, f, p, p, i, i, i, p, p, p, p, p, p, p, ll]
    return kernels.load_library(source, NVCC_FLAGS, {
        "adaprox_resident_bt_parts": ([], i),
        "adaprox_resident_bt_group": ([], i),
        "adaprox_resident_bt_plan": ([i, ll, ll, i, i, p], i),
        "adaprox_resident_bt": (problem + [p, p, p, ll, ll, i, f, f, f, f, f, f, i, i, i, i, p,
                                           p], i),
        "adaprox_resident_bt_sweep": (problem + [p, i, p, p, p, ll, ll, i, f, f, f, f, i, i, p,
                                                 p], i),
        "adaprox_resident_bt_error_string": ([i], ctypes.c_char_p)})


# K4/K4b's plan (csrc/resident_bt.cu, bt_plan): 16 warps a CTA, at most one CTA an SM
K4B_GROUP = 8                 # kGroup: the rows a lockstep group runs at once
K4B_WARPS = 16                # kWarps
K4B_PARTS = 14                # kBtParts: two halves of (P1's 3 + the trial's 4) a row a CTA
K4B_CTA_SMEM = 232448         # the most shared memory a CTA may take (227 KB)
K4B_STATIC_SMEM = 8192        # what the launcher keeps of it for the static shared memory
K4B_ROUTES = ("staged", "fly")
# the launcher's plan, in its order
K4B_PLAN_KEYS = ("grid", "group", "route", "a_held", "rows_per_warp", "smem_bytes")


def k4b_plan(count, m, n, itemsize, sms):
    """K4b's launch for ``count`` rows at (m, n) with A's ``itemsize`` (4: f32, 2: bf16)
    on a card of ``sms`` SMs (K4: ``count`` 1), as the C launcher computes it: a dict of
    ``K4B_PLAN_KEYS`` and

    * ``groups``: the rows' indices in lockstep groups of at most K4B_GROUP, in table
      order; ``group`` the rows of the first (largest);
    * ``grid``: K2's grid for the shape, min(ceil(max(m, n) / 16), sms); warp w of CTA c
      owns A's rows c 16 + w + k 16 grid, ``rows_per_warp`` of them at most;
    * ``route``: "staged" where the group's points (``group`` x n f32) fit a CTA's shared
      memory beside the kernel's static (227 KB less K4B_STATIC_SMEM): each CTA forms a
      trial's z (or the momentum point) for all n coordinates in shared memory before
      its pass over A; else "fly": each dot forms z_j as it goes;
    * ``a_held``: on route "staged", where the CTA's rows of A (16 ``rows_per_warp`` rows
      of n ``itemsize`` bytes, rounded up to 16 bytes) fit beside the points: each CTA
      copies its rows of A into shared memory once a launch, and every pass over A reads
      them there; else from device memory (the L2) every pass;
    * ``smem_bytes``: the CTA's dynamic shared memory (the held rows, then the points);
    * ``scratch``: the shapes the wrapper allocates: K4's scratch once for each row of
      the largest group, ``part`` K4B_PARTS x that x ``sms`` floats.

    The layout depends on the shape, the storage, the row count and the SM count alone. No
    row's arithmetic follows it: both routes form z_j with its owner's expression, a held
    row is the same values read from another memory, and row g runs K4's sums in K4's
    order on K4's grid, so its bits depend on (m, n, dtype) and its own arguments, not on
    its group, its place there or the rows beside it."""
    if itemsize not in (2, 4):
        raise ValueError(f"K4b stores A as float32 or bfloat16, got itemsize {itemsize}")
    if count < 1 or m < 1 or n < 1 or sms < 1:
        raise ValueError(f"K4b needs count, m, n, sms >= 1, got {count}, {m}, {n}, {sms}")
    groups = [list(range(s, min(count, s + K4B_GROUP))) for s in range(0, count, K4B_GROUP)]
    g0 = len(groups[0])
    grid = min(-(-max(m, n) // K4B_WARPS), sms)
    rows_per_warp = -(-m // (grid * K4B_WARPS))
    points = 4 * g0 * n
    held = -(-(K4B_WARPS * rows_per_warp * n * itemsize) // 16) * 16
    budget = K4B_CTA_SMEM - K4B_STATIC_SMEM
    staged = points <= budget
    a_held = staged and held + points <= budget
    return dict(groups=groups, group=g0, grid=grid, route=K4B_ROUTES[0 if staged else 1],
                a_held=a_held, rows_per_warp=rows_per_warp,
                smem_bytes=(held if a_held else 0) + (points if staged else 0),
                scratch=dict(xs=(g0, 2, n), gs=(g0, 2, n), v=(g0, n), res=(g0, 2, m),
                             part=g0 * K4B_PARTS * sms))


def k4b_card_plan(count, m, n, itemsize, sms):
    """The C launcher's plan (``adaprox_resident_bt_plan``) for the same arguments as
    ``k4b_plan``, as a dict of K4B_PLAN_KEYS; the card's tests and chip_smoke.py hold
    the two equal."""
    out = (ctypes.c_longlong * len(K4B_PLAN_KEYS))()
    lib = _library()
    _raise_on(lib.adaprox_resident_bt_error_string,
              lib.adaprox_resident_bt_plan(count, m, n, itemsize, sms, out),
              "adaprox_resident_bt_plan")
    plan = dict(zip(K4B_PLAN_KEYS, (int(v) for v in out)))
    plan["route"] = K4B_ROUTES[plan["route"]]
    plan["a_held"] = bool(plan["a_held"])
    return plan


def k4b_syncs(groups, numits, trials, nesterovs, cubic=False):
    """The grid syncs of a K4 or K4b launch from its records: ``groups`` (``k4b_plan``'s),
    each row's ``numits``, ``trials`` (its trial count for each of its iterations, the
    record's fourth history up to numit) and ``nesterovs`` (its momentum flag); ``cubic``
    for ``obj_kind="cubic"``.

    A row's chain of phases: one a trial; after each iteration it goes on from, one
    (PG: the gradient at z) or two (Nesterov: the momentum point's forward pass and its
    gradient). "cubic" forms its elementwise gradient inside the next trial, so there
    PG takes none and Nesterov one (the momentum point). A group pays two syncs of
    warm-up (f and the gradient at x0) when its rows run (every row runs at least one
    iteration then), and then the phases of its longest row; a sync between two
    groups."""
    total = len(groups) - 1
    for grp in groups:
        chains = [sum(int(t) for t in trials[j][:int(numits[j])])
                  + max(int(numits[j]) - 1, 0) * (int(bool(nesterovs[j])) + (not cubic))
                  for j in grp]
        if any(int(numits[j]) > 0 for j in grp):
            total += 2 + max(chains)
    return total


def _raise_on(error_string, err, what):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({error_string(err).decode()})")


def _check(what, a, b, x0, prox_kind, obj_kind, maxit):
    _check_menu(what, a, prox_kind, obj_kind)
    kernels._check_shapes(a, b, x0)
    if int(maxit) < 0:
        raise ValueError(f"{what}: maxit must be >= 0, got {maxit}")


def _scratch(lib, a, b, x0, obj_kind, m_true, cube_c, what, count):
    """The problem's leading arguments with K4's scratch once for each row of the largest
    group of ``count`` rows (the build's kBtParts and kGroup checked), and an int on the
    device for the launch's grid syncs."""
    if lib.adaprox_resident_bt_parts() != K4B_PARTS or lib.adaprox_resident_bt_group() != K4B_GROUP:
        raise RuntimeError("csrc/resident_bt.cu's kBtParts or kGroup differs from K4B_PARTS or "
                           "K4B_GROUP")
    # k4b_plan's scratch (its group: the rows of the first group)
    args, keep = _problem(K4B_PARTS, a, b, x0, obj_kind, m_true, cube_c, what, res_bufs=2,
                          copies=min(count, K4B_GROUP))
    return args, keep, torch.zeros(1, dtype=torch.int32, device=a.device)


def _launch(a, b, x0, gamma0, tol, maxit, xi, shrink, prox_kind, p1, p2, cube_c, nesterov,
            obj_kind, m_true, record, exact_bregman, lib=None):
    """One K4 launch on checked inputs, from ``lib`` (default: the build of SOURCE)."""
    lib = lib or _library()
    dev = a.device
    n = a.shape[1]
    with torch.cuda.device(dev):
        # keep: the tensors behind args; res holds the residuals at x and at z
        args, keep, syncs = _scratch(lib, a, b, x0, obj_kind, m_true, cube_c, "K4", 1)
        f32 = dict(dtype=torch.float32, device=dev)
        x_out, stats = torch.empty(n, **f32), torch.empty(5, **f32)
        hist = torch.empty((4, maxit), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_bt(
            *args, x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None, *a.shape, maxit, float(gamma0),
            1.0 if nesterov else float(xi), float(shrink), float(tol), float(p1), float(p2),
            _PROX_IDX[prox_kind], int(bool(nesterov)), int(bool(exact_bregman)), int(record),
            syncs.data_ptr(), stream)
    _raise_on(lib.adaprox_resident_bt_error_string, err, "K4 launch")
    resident_backtracking.launches += 1
    resident_backtracking.last_syncs = syncs
    base = (x_out, stats[0].to(torch.int32), stats[1], stats[3] > 0, stats[4] > 0)
    return base + tuple(hist) if record else base


def resident_backtracking(a, b, x0, gamma0, tol, maxit, *, xi=1.0, shrink=0.5, prox_kind="l1",
                          p1=0.0, p2=0.0, cube_c=0.0, nesterov=False, obj_kind="ls",
                          m_true=None, record=False, exact_bregman=False):
    """Whole-solve backtracking PG (``nesterov=False``, the trial step
    inflated by ``xi`` each iteration, src/AdaProx.jl:54) or backtracking
    Nesterov (``nesterov=True``, no inflation, src/AdaProx.jl:72) in one
    kernel launch, with f and (p1, p2) as ``ops.resident.resident_adapgm``
    takes them and gamma shrunk by ``shrink`` on each failed trial.

    a: (m, n); b: (m,) (the cubic model's q with a = H, m = n); x0: (n,).
    Returns (x, numit, norm_res, converged, ls_failed) as tensors on the
    input's device, plus (gamma_hist, norm_res_hist, objective_hist,
    trials_hist) of shape (maxit,) when ``record=True`` (zero past numit);
    ``resident_bt_records`` turns those into ``Records``.

    ``exact_bregman``: the cancellation-resistant sufficient-descent test
    0.5 ||res_z - res_x||^2 > ||dz||^2 / (2 gamma), for ``obj_kind="ls"``
    only, as in the JAX package; the other objectives keep the raw test.

    CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K4: ``a`` f32 or bf16, ``b`` and ``x0`` f32, all contiguous; each launch
    adds one to ``resident_backtracking.launches`` and leaves the grid syncs it
    took in ``resident_backtracking.last_syncs`` (an int32 tensor on the device;
    ``k4b_syncs`` counts them from the records)."""
    _check("resident_backtracking", a, b, x0, prox_kind, obj_kind, maxit)
    if a.device.type == "cpu":
        return resident_backtracking_plain(
            a, b, x0, gamma0, tol, maxit, xi=xi, shrink=shrink, prox_kind=prox_kind, p1=p1,
            p2=p2, cube_c=cube_c, nesterov=nesterov, obj_kind=obj_kind, m_true=m_true,
            record=record, exact_bregman=exact_bregman)
    if a.device.type != "cuda":
        raise ValueError(f"K4 runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch(a, b, x0, gamma0, tol, int(maxit), xi, shrink, prox_kind, p1, p2, cube_c,
                   nesterov, obj_kind, m_true, record, exact_bregman)


resident_backtracking.launches = 0
resident_backtracking.last_syncs = None


def _launch_sweep(a, b, x0, rows, tol, maxit, shrink, prox_kind, p1, p2, cube_c, obj_kind,
                  m_true, exact_bregman, lib=None):
    """One K4b launch on checked inputs, from ``lib`` (default: the build of SOURCE)."""
    lib = lib or _library()
    dev = a.device
    n = a.shape[1]
    count = rows.shape[0]
    with torch.cuda.device(dev):
        args, keep, syncs = _scratch(lib, a, b, x0, obj_kind, m_true, cube_c, "K4b", count)
        f32 = dict(dtype=torch.float32, device=dev)
        rows_d = rows.to(**f32).contiguous()
        x_out, stats = torch.empty((count, n), **f32), torch.empty((count, 5), **f32)
        hist = torch.empty((count, 4, maxit), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_bt_sweep(
            *args, rows_d.data_ptr(), count, x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if maxit else None, *a.shape, maxit, float(shrink), float(tol),
            float(p1), float(p2), _PROX_IDX[prox_kind], int(bool(exact_bregman)),
            syncs.data_ptr(), stream)
    _raise_on(lib.adaprox_resident_bt_error_string, err, "K4b launch")
    resident_bt_sweep.launches += 1
    resident_bt_sweep.last_syncs = syncs
    return (x_out, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 3] > 0, stats[:, 4] > 0,
            tuple(hist[:, k] for k in range(4)))


def resident_bt_sweep(a, b, x0, rows, tol, maxit, *, shrink=0.5, prox_kind="l1", p1=0.0,
                      p2=0.0, cube_c=0.0, obj_kind="ls", m_true=None, exact_bregman=False):
    """Every backtracking row of an experiment as ONE record-mode launch:
    ``rows`` is an (R, 3) array of [gamma0, xi, nesterov_flag], the flag 0
    (PG) or 1 (Nesterov); the trial step is gamma * xi for every row, so a
    Nesterov row passes xi = 1. Other arguments as ``resident_backtracking``.
    Returns (x (R, n), numit (R,), norm_res (R,), converged (R,), ls_failed
    (R,), (hg, hr, ho, ht) each (R, maxit)); feed each row to
    ``resident_bt_records`` with its own flag.

    CPU tensors take the plain version. CUDA tensors launch K4b, with what K4
    takes, its rows in lockstep groups (``k4b_plan``); each launch adds one to
    ``resident_bt_sweep.launches`` and leaves its grid syncs in
    ``resident_bt_sweep.last_syncs``. Row j equals ``resident_backtracking``
    with row j's arguments. A rows table that is not (R >= 1, 3), or a flag
    outside {0, 1}, is refused."""
    _check("resident_bt_sweep", a, b, x0, prox_kind, obj_kind, maxit)
    rows = _bt_rows(rows, x0.dtype)
    if a.device.type == "cpu":
        return resident_bt_sweep_plain(a, b, x0, rows, tol, maxit, shrink=shrink,
                                       prox_kind=prox_kind, p1=p1, p2=p2, cube_c=cube_c,
                                       obj_kind=obj_kind, m_true=m_true,
                                       exact_bregman=exact_bregman)
    if a.device.type != "cuda":
        raise ValueError(f"K4b runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch_sweep(a, b, x0, rows, tol, int(maxit), shrink, prox_kind, p1, p2, cube_c,
                         obj_kind, m_true, exact_bregman)


resident_bt_sweep.launches = 0
resident_bt_sweep.last_syncs = None


def _agraal_library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # obj_kind .. part_len, the leading arguments (as K2's)
    problem = [i, f, f, f, p, p, i, i, i, p, p, p, p, p, p, p, ll]
    return kernels.load_library(AGRAAL_SOURCE, NVCC_FLAGS, {
        "adaprox_resident_agraal_parts": ([], i),
        "adaprox_resident_agraal": (problem + [p, p, p, p, ll, ll, i, f, f, f, f, f, f, i, i, p],
                                    i),
        "adaprox_resident_agraal_error_string": ([i], ctypes.c_char_p)})


def _launch_agraal(a, b, x1, x0, gamma0, tol, maxit, gamma_max, phi, prox_kind, p1, p2, cube_c,
                   obj_kind, m_true, record):
    lib = _agraal_library()
    dev = a.device
    n = a.shape[1]
    if x0.device != dev or x0.dtype != torch.float32 or not x0.is_contiguous():
        raise TypeError(f"K4 (aGRAAL) takes a contiguous float32 x0 on {dev}, got {x0.dtype} "
                        f"on {x0.device}")
    with torch.cuda.device(dev):
        # keep: the tensors behind args; x1 rides in the problem's x0 slot
        args, keep = _problem(lib.adaprox_resident_agraal_parts(), a, b, x1, obj_kind, m_true,
                              cube_c, "K4 (aGRAAL)")
        f32 = dict(dtype=torch.float32, device=dev)
        x_out, stats = torch.empty(n, **f32), torch.empty(5, **f32)
        hist = torch.empty((3, maxit), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_agraal(
            *args, x0.data_ptr(), x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None, *a.shape, maxit, float(gamma0),
            float(gamma_max), float(phi), float(tol), float(p1), float(p2), _PROX_IDX[prox_kind],
            int(record), stream)
    _raise_on(lib.adaprox_resident_agraal_error_string, err, "K4 (aGRAAL) launch")
    resident_agraal.launches += 1
    base = (x_out, stats[0].to(torch.int32), stats[1], stats[3] > 0)
    return base + tuple(hist) if record else base


def resident_agraal(a, b, x1, x0, gamma0, tol, maxit, *, gamma_max=1e6, phi=1.5, prox_kind="l1",
                    p1=0.0, p2=0.0, cube_c=0.0, obj_kind="ls", m_true=None, record=False):
    """Whole-solve aGRAAL in one kernel launch (reference
    src/AdaProx.jl:150-192), with f and (p1, p2) as
    ``ops.resident.resident_adapgm`` takes them. ``x0`` is the companion
    point (the engine draws x1 + noise; pass the same to match its
    trajectory, and keep zero-padded coordinates 0 so that the padded sums
    are exact); ``gamma0 <= 0`` selects the secant estimate
    ||x1 - x0|| / ||grad(x1) - grad(x0)||.

    a: (m, n); b: (m,) (the cubic model's q with a = H, m = n); x1, x0: (n,).
    Returns (x, numit, norm_res, converged) as tensors on the input's device,
    plus (gamma_hist, norm_res_hist, objective_hist) of shape (maxit,) when
    ``record=True`` (zero past numit); ``resident_agraal_records`` turns those
    into ``Records``.

    CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K4's aGRAAL kernel (``csrc/resident_agraal.cu``): ``a`` f32 or bf16,
    ``b``, ``x1`` and ``x0`` f32, all contiguous; each launch adds one to
    ``resident_agraal.launches``."""
    _check("resident_agraal", a, b, x1, prox_kind, obj_kind, maxit)
    if x0.shape != x1.shape:
        raise ValueError(f"resident_agraal: x0 {tuple(x0.shape)} must have x1's shape "
                         f"{tuple(x1.shape)}")
    if a.device.type == "cpu":
        return resident_agraal_plain(a, b, x1, x0, gamma0, tol, maxit, gamma_max=gamma_max,
                                     phi=phi, prox_kind=prox_kind, p1=p1, p2=p2, cube_c=cube_c,
                                     obj_kind=obj_kind, m_true=m_true, record=record)
    if a.device.type != "cuda":
        raise ValueError(f"K4 (aGRAAL) runs on CPU (plain version) or CUDA tensors, not "
                         f"{a.device}")
    return _launch_agraal(a, b, x1, x0, gamma0, tol, int(maxit), gamma_max, phi, prox_kind, p1,
                          p2, cube_c, obj_kind, m_true, record)


resident_agraal.launches = 0

