"""K2 and K2c, the whole-solve kernels: complete proximal-gradient solves of
f(x) + g(x) in one launch, f the least-squares loss 0.5 ||A x - b||^2
(``obj_kind="ls"``), the mean logistic loss with the bias folded into A as
a ones column (``obj_kind="logreg"``, labels b in {0, 1}), or the cubic
model 0.5 x'Hx + q'x + (c/6)||x||^3 with A = H square and b = q
(``obj_kind="cubic"``, c = ``cube_c``).

Counterpart of ``adaprox_tpu/ops/resident.py`` for every ``obj_kind`` of
K2/K2c ("ls", "logreg", "cubic"): ``resident_adapgm`` (K2,
one solve; the Pallas TPU kernel over ``_solve_core``), its aliases
``resident_adapgm_l1`` and ``resident_logreg_l1``, and
``resident_rule_sweep`` (K2c, the rule rows of a method menu in one launch,
each row with its own gamma0, rule, momentum flag, tol and iteration cap).
Step-size rules fixed / Malitsky-Mishchenko / AdaPGM or the Nesterov
momentum body (``fixed_nesterov`` with mu = 0), prox kinds l1 / box /
elastic / zero, and the record mode that returns per-iteration histories.
Here both kernels are hand-written CUDA C++ for Hopper
(``csrc/resident_pg.cu``): one cooperative launch with grid-wide barriers
between the phases of an iteration, built with nvcc for ``sm_90a`` at first
use and loaded with ctypes, like K1 (``ops/kernels.py``). K2c runs the rows of
a sweep in lockstep groups (``k2c_plan``) on K2's grid, each pass over A and
each grid sync shared by the rows of a group; each row keeps K2's order of
every sum, so a sweep row equals the single solve with its arguments bit for
bit.

Both entries dispatch on where their tensors lie: CPU tensors take the plain
versions ``resident_adapgm_plain`` / ``resident_rule_sweep_plain`` (Python
loops over the same iteration); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..solvers.common import Records
from . import kernels

__all__ = ["resident_supported", "resident_adapgm", "resident_adapgm_plain",
           "resident_adapgm_l1", "resident_logreg_l1", "resident_rule_sweep",
           "resident_rule_sweep_plain", "rule_rows", "resident_records",
           "resident_adapgm_batch", "resident_adapgm_batch_plain", "build_library", "k2c_plan"]

SOURCE = kernels._PKG / "csrc" / "resident_pg.cu"
# -fmad=false: every elementwise expression rounds after each operation, as the
# plain version's tensor ops do (the kernel's dot products use explicit fmaf)
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)

# static prox menu: kind -> (v, gamma, p1, p2) -> prox point
_PROX = {
    "l1": lambda v, gamma, p1, p2: torch.sign(v) * torch.clamp_min(torch.abs(v) - gamma * p1, 0.0),
    "box": lambda v, gamma, p1, p2: torch.minimum(torch.maximum(v, p1), p2),
    "elastic": lambda v, gamma, p1, p2: (
        torch.sign(v) * torch.clamp_min(torch.abs(v) - gamma * p1, 0.0) / (1 + gamma * p2)),
    "zero": lambda v, gamma, p1, p2: v,
}

# g(x) for the record-mode objective (indicators are 0 at feasible points)
_GVAL = {
    "l1": lambda x, p1, p2: p1 * torch.sum(torch.abs(x)),
    "box": lambda x, p1, p2: torch.zeros((), dtype=x.dtype, device=x.device),
    "elastic": lambda x, p1, p2: p1 * torch.sum(torch.abs(x)) + 0.5 * p2 * torch.sum(x * x),
    "zero": lambda x, p1, p2: torch.zeros((), dtype=x.dtype, device=x.device),
}

# The JAX driver's routing limit: both layouts of A in a TPU core's VMEM.
_VMEM_BYTES = 24 * 1024 * 1024


def resident_supported(a) -> bool:
    """Whether the JAX driver routes ``a`` to its whole-solve kernel
    (tile-aligned, both layouts within the TPU's VMEM). The port's lasso
    driver applies it on the CPU only, so its JSONL there follows the JAX
    driver's row for row; the CUDA kernel takes any shape, and on the card
    the driver sends every shape to it."""
    m, n = a.shape
    return m % 8 == 0 and n % 128 == 0 and a.element_size() * m * n <= _VMEM_BYTES


def _rule_adapgm(g1, g0, ndg2, dgdx, ndx2):
    """AdaPGM update (PG case): 0/0 -> 0, and the inf of g1 / sqrt(0) is
    dropped by the min."""
    dd_raw = g1 * (g1 * ndg2 - dgdx) / ndx2
    dd = torch.where(torch.isnan(dd_raw), torch.zeros_like(dd_raw), dd_raw)
    denom = torch.clamp_min(dd + torch.sqrt(dd * dd), 0.0)
    gamma = torch.minimum(g1 * torch.sqrt(1 + g1 / g0), g1 / torch.sqrt(2.0 * denom))
    return gamma, gamma, g1


def _rule_mm(g1, g0, ndg2, dgdx, ndx2):
    """Malitsky-Mishchenko update; state reuse: g1 = gamma_prev, g0 = rho."""
    lip = torch.sqrt(ndg2) / torch.sqrt(ndx2)
    growth = torch.where(torch.isfinite(g0), torch.sqrt(1 + g0) * g1,
                         torch.full_like(g0, math.inf))
    gamma = torch.where(torch.isnan(lip), growth, torch.minimum(growth, 1 / (2 * lip)))
    return gamma, gamma, gamma / g1


def _rule_fixed(g1, g0, ndg2, dgdx, ndx2):
    return g1, g1, g0


_RULES = {"fixed": _rule_fixed, "mm": _rule_mm, "adapgm": _rule_adapgm}
_OBJ_IDX = {"ls": 0, "logreg": 1, "cubic": 2}
_PROX_IDX = {"l1": 0, "box": 1, "elastic": 2, "zero": 3}
_RULE_IDX = {"fixed": 0, "mm": 1, "adapgm": 2}
_RULE_OF_IDX = {v: k for k, v in _RULE_IDX.items()}


def _m_div(a, m_true):
    """The logistic mean's divisor and the padded rows: ``m_true`` (the
    unpadded row count) or all rows of ``a`` ((m, n), or (B, m, n))."""
    m = a.shape[-2]
    m_div = float(m if m_true is None else m_true)
    if not 0 < m_div <= m:
        raise ValueError(f"m_true must be in (0, m={m}], got {m_true}")
    return m_div, m - m_div


def _transposed(a, obj_kind, m_true):
    """The second layout of A that the gradient reads: A^T, divided by the
    mean's divisor for "logreg" (in A's storage dtype, as the JAX package's
    caller builds it), so that the kernel and the plain version read the
    same bits. "cubic" reads no second layout (H x is its only matvec): A
    itself, no copy. A (B, m, n) batch is transposed instance by instance."""
    if obj_kind == "logreg":
        return a.transpose(-2, -1) / _m_div(a, m_true)[0]
    if obj_kind == "cubic":
        return a
    return a.transpose(-2, -1)


def _obj_split(a, at, b, obj_kind, m_true, cube_c=0.0):
    """The smooth oracle of ``_solve_core`` (``_obj_split`` in the JAX
    package) as (val_aux_of, grad_from_aux):
      * "ls": f = 0.5 ||A x - b||^2, aux = the residual, grad = A' res;
      * "logreg": aux = sigmoid(z) at the logits z = A x, f = -(sum((b - 1) z
        - softplus(-z)) + pad_rows log 2) / m_true (each zero-padded row adds
        exactly -log 2 to the raw sum), grad = (A' / m_true)(sigmoid(z) - b)
        with ``at`` already divided;
      * "cubic": A = H, b = q, c = ``cube_c``; aux = grad = H x + q +
        (||x|| c / 2) x from one matvec, f = (<x, grad> + <q, x>) / 2 -
        ||x||^3 c / 12, in the JAX kernel's order (``nx * nx * nx``, where
        ``models.objectives.Cubic`` writes ``nx**3``)."""
    if obj_kind == "cubic":
        def val_aux_of(x):
            hx = torch.mv(a, x)
            nx = torch.sqrt(torch.sum(x * x))
            grad = hx + b + (nx * cube_c / 2) * x
            val = (torch.sum(x * grad) + torch.sum(b * x)) / 2 - nx * nx * nx * cube_c / 12
            return val, grad

        def grad_from_aux(grad):
            return grad
    elif obj_kind == "logreg":
        m_div, pad_rows = _m_div(a, m_true)

        def val_aux_of(x):
            terms, probs = kernels.logistic_terms(torch.mv(a, x), b)
            return -(torch.sum(terms) + pad_rows * math.log(2.0)) / m_div, probs

        def grad_from_aux(probs):
            return torch.mv(at, probs - b)
    else:
        def val_aux_of(x):
            res = torch.mv(a, x) - b
            return 0.5 * torch.sum(res * res), res

        def grad_from_aux(res):
            return torch.mv(at, res)
    return val_aux_of, grad_from_aux


def resident_adapgm_plain(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                          rule_kind="adapgm", momentum=False, record=False, obj_kind="ls",
                          m_true=None, cube_c=0.0):
    """The plain PyTorch version of the kernel: ``_solve_core``'s loop for
    ``obj_kind`` "ls", "logreg" or "cubic", one host-checked iteration at a time.
    ``momentum`` runs its momentum body instead of the rule's (the rule is
    then unused). Scalars are 0-d tensors in the iterate dtype; bf16 storage
    of ``a`` is upcast to it (for "logreg" after A^T is divided by the mean's
    divisor in storage dtype, as the kernel's wrapper does). Returns what
    ``resident_adapgm`` returns."""
    dt, dev = x0.dtype, x0.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    gamma0, tol, p1, p2, cube_c = (scalar(v) for v in (gamma0, tol, p1, p2, cube_c))
    inf = scalar(math.inf)
    at = _transposed(a, obj_kind, m_true).to(dt)
    a = a.to(dt)
    b = b.to(dt)
    val_aux_of, grad_from_aux = _obj_split(a, at, b, obj_kind, m_true, cube_c)
    prox_fn, gval_fn, rule_fn = _PROX[prox_kind], _GVAL[prox_kind], _RULES[rule_kind]
    hists = torch.zeros((3, maxit), dtype=dt, device=dev)
    gamma = gamma0
    norm_res = inf
    it = 0

    if momentum:
        # body_mom (_solve_core :269-286) from x = x_prev = x0, theta = 0; the
        # warm-up gradient is not used there, so it is not computed
        x = x_prev = ck_x = x0
        theta = scalar(0.0)
        while it < maxit and bool(norm_res > tol):
            theta_next = (1 + torch.sqrt(1 + 4 * theta * theta)) / 2
            beta = (theta - 1) / theta_next
            z = x + beta * (x - x_prev)
            grad = grad_from_aux(val_aux_of(z)[1])
            x_new = prox_fn(z - gamma * grad, gamma, p1, p2)
            d = x_new - z
            norm_res = torch.sqrt(torch.sum(d * d)) / gamma
            if record:
                # objective at the NEW iterate: one more forward matvec
                objective = val_aux_of(x_new)[0] + gval_fn(x_new, p1, p2)
                hists[:, it] = torch.stack([gamma, norm_res, objective])
            # the residual is checked AT x_new, which is returned either way
            x_prev, x, ck_x, theta = x, x_new, x_new, theta_next
            it += 1
    else:
        # warm-up (the engine's init)
        grad0 = grad_from_aux(val_aux_of(x0)[1])
        v = x0 - gamma0 * grad0
        x = prox_fn(v, gamma0, p1, p2)
        x_prev, grad_prev, ck_x = x0, grad0, x
        g1 = gamma0
        g0 = inf if rule_kind == "mm" else gamma0
        while it < maxit and bool(norm_res > tol):  # a NaN residual stops
            f_x, aux = val_aux_of(x)
            grad = grad_from_aux(aux)
            primal = (v - x) / gamma + grad
            norm_res = torch.sqrt(torch.sum(primal * primal))
            dg = grad - grad_prev
            dx = x - x_prev
            gamma, g1, g0 = rule_fn(g1, g0, torch.sum(dg * dg), torch.sum(dg * dx),
                                    torch.sum(dx * dx))
            if record:
                # objective at the CURRENT x, gamma the step just updated
                objective = f_x + gval_fn(x, p1, p2)
                hists[:, it] = torch.stack([gamma, norm_res, objective])
            v = x - gamma * grad
            # the residual is checked AT x: on convergence that iterate is
            # returned, not the extra prox step (ck_x)
            x_prev, grad_prev, ck_x = x, grad, x
            x = prox_fn(v, gamma, p1, p2)
            it += 1
    conv = norm_res <= tol
    # the TPU kernel's stats travel as f32: numit and norm_res round through it
    stats = torch.stack([scalar(it), norm_res, gamma, conv.to(dt)]).to(torch.float32)
    base = (torch.where(conv, ck_x, x), stats[0].to(torch.int32), stats[1].to(dt),
            stats[3] > 0)
    return base + tuple(hists) if record else base


def build_library():
    """Compile ``csrc/resident_pg.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library(source=SOURCE):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # obj_kind .. part_len, the leading arguments of the three entries
    problem = [i, f, f, f, p, p, i, i, i, p, p, p, p, p, p, p, ll]
    return kernels.load_library(source, NVCC_FLAGS, {
        "adaprox_resident_pg_parts": ([], i),
        "adaprox_resident_pg": (problem + [p, p, p, ll, ll, i, f, f, f, f, i, i, i, i, p], i),
        "adaprox_resident_pg_group": ([], i),
        "adaprox_resident_pg_sweep": (problem + [p, p, i, p, p, p, ll, ll, i, f, f, i, p], i),
        "adaprox_resident_pg_batch": (problem + [ll, ll, p, i, p, p, ll, ll, i, i, i, i, p], i),
        "adaprox_resident_pg_error_string": ([i], ctypes.c_char_p)})


def _raise_on(lib, err, what):
    if err:
        msg = lib.adaprox_resident_pg_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _vec(rows_len, dtype, ptr):
    """Vector width of the kernel's 16-byte loads along rows of ``rows_len``."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return vec if rows_len % vec == 0 and ptr % 16 == 0 else 1


def _problem(parts, a, b, x0, obj_kind, m_true, cube_c, what, res_bufs=1, copies=1):
    """Check what the kernels take, and make the second layout of A and the
    scratch of one launch (on the current device), with ``parts`` partial
    sums a CTA and ``res_bufs`` buffers of length m, ``copies`` times over (K2c:
    one copy for each row of a lockstep group). A batch (K2b) passes a
    (B, m, n) A, b (B, m) and x0 (B, n), whose instances share the scratch;
    its A may be one contiguous (m, n) A expanded over B (batch stride 0),
    which is read from that one copy, with one A^T. Returns the leading
    arguments of the C entries (obj_kind .. part_len) and the tensors behind
    them."""
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} stores A as float32 or bfloat16 on CUDA, got {a.dtype}")
    if b.dtype != torch.float32 or x0.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 b and x0 on CUDA, got {b.dtype}, {x0.dtype}")
    # a batch's one shared A: the instances read its one copy
    a_one = a[0] if a.ndim == 3 and a.stride(0) == 0 else a
    if not (a_one.is_contiguous() and b.is_contiguous() and x0.is_contiguous()):
        raise ValueError(f"{what} needs contiguous a, b and x0"
                         + (", or one contiguous (m, n) A expanded over B" if a.ndim == 3
                            else ""))
    m, n = a.shape[-2:]
    if m < 1 or n < 1:
        raise ValueError(f"{what} needs m, n >= 1, got {tuple(a.shape)}")
    dev = a.device
    m_div, pad_rows = _m_div(a, m_true) if obj_kind == "logreg" else (1.0, 0.0)
    # the second layout, made once per launch (it counts in the launch's time);
    # "cubic" passes A itself, which its kernel does not read as A^T
    at = _transposed(a_one, obj_kind, m_true).contiguous()
    va, vt = _vec(n, a.dtype, a_one.data_ptr()), _vec(m, a.dtype, at.data_ptr())
    f32 = dict(dtype=torch.float32, device=dev)
    xs, gs = torch.empty((copies, 2, n), **f32), torch.empty((copies, 2, n), **f32)
    v, res = torch.empty((copies, n), **f32), torch.empty(copies * res_bufs * m, **f32)
    # the launcher sizes the grid, at most one CTA per SM
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # zeroed: "ls" and "logreg" never write the cubic objective's slot, which P3 sums
    part = torch.zeros(copies * parts * sms, **f32)
    tensors = (a_one, at, b, x0, xs, gs, v, res, part)
    args = [_OBJ_IDX[obj_kind], pad_rows * math.log(2.0), m_div, float(cube_c), a_one.data_ptr(),
            at.data_ptr(),
            int(a.dtype == torch.bfloat16), va, vt, *(t.data_ptr() for t in tensors[2:]),
            part.numel()]
    return args, tensors


def _launch(a, b, x0, gamma0, tol, maxit, prox_kind, p1, p2, rule_kind, momentum, record,
            obj_kind, m_true, cube_c, lib=None):
    """One K2 launch on checked inputs, from ``lib`` (default: the build of SOURCE)."""
    lib = lib or _library()
    dev = a.device
    n = a.shape[1]
    with torch.cuda.device(dev):
        # keep: the tensors behind args
        args, keep = _problem(lib.adaprox_resident_pg_parts(), a, b, x0, obj_kind, m_true,
                              cube_c, "K2")
        f32 = dict(dtype=torch.float32, device=dev)
        x_out, stats = torch.empty(n, **f32), torch.empty(4, **f32)
        hist = torch.empty((3, maxit), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_pg(
            *args, x_out.data_ptr(), stats.data_ptr(),
            hist.data_ptr() if record and maxit else None, *a.shape, maxit, float(gamma0),
            float(tol), float(p1), float(p2), _PROX_IDX[prox_kind], _RULE_IDX[rule_kind],
            int(momentum), int(record), stream)
    _raise_on(lib, err, "K2 launch")
    resident_adapgm.launches += 1
    base = (x_out, stats[0].to(torch.int32), stats[1], stats[3] > 0)
    return base + tuple(hist) if record else base


def _check_menu(what, a, prox_kind, obj_kind):
    if obj_kind not in _OBJ_IDX:
        raise ValueError(f"obj_kind must be one of {sorted(_OBJ_IDX)}, got {obj_kind!r}")
    if prox_kind not in _PROX:
        raise ValueError(f"prox_kind must be one of {sorted(_PROX)}, got {prox_kind!r}")
    if obj_kind == "cubic" and (a.ndim != 2 or a.shape[0] != a.shape[1]):
        # b = q has the length of x: the JAX kernel fails on the broadcast H x + q
        raise ValueError(f"{what}: obj_kind='cubic' needs a square H (n, n) with q and x0 "
                         f"of length n, got a {tuple(a.shape)}")


def resident_adapgm(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                    rule_kind="adapgm", momentum=False, obj_kind="ls", m_true=None,
                    record=False, cube_c=0.0):
    """Full proximal-gradient solve of f(x) + g(x) in one kernel launch, with
    f = 0.5||Ax-b||^2 (``obj_kind="ls"``), the mean logistic loss of the
    rows of A with labels b in {0, 1} (``obj_kind="logreg"``; the bias is a
    ones column of A, ``m_true`` the unpadded row count that divides the
    mean) or the cubic model 0.5 x'Ax + b'x + (cube_c/6)||x||^3 with A
    square and symmetric (``obj_kind="cubic"``), g from the static prox
    menu ("l1", "box", "elastic", "zero")
    parameterized by (p1, p2) and the step-size rule from {"adapgm", "mm",
    "fixed"}. ``momentum=True`` runs the accelerated (fixed_nesterov)
    iteration with the fixed step gamma0 instead, and the rule is ignored,
    as in the JAX package.

    a: (m, n); b: (m,); x0: (n,). Returns (x, numit, norm_res, converged) as
    tensors on the input's device, plus (gamma_hist, norm_res_hist,
    objective_hist) of shape (maxit,) when ``record=True`` (zero past numit);
    ``resident_records`` turns those into ``Records``.

    CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K2: ``a`` f32 or bf16, ``b`` and ``x0`` f32, all contiguous; each launch
    adds one to ``resident_adapgm.launches``. ``m_true`` is ignored unless
    "logreg" and ``cube_c`` unless "cubic", as in the JAX package."""
    _check_menu("resident_adapgm", a, prox_kind, obj_kind)
    if rule_kind == "dynamic":
        raise ValueError("resident_adapgm: rule_kind='dynamic' takes each row's rule from a "
                         "rows table, which only resident_rule_sweep has (as in the JAX "
                         "package); pass 'fixed', 'mm' or 'adapgm'")
    if rule_kind not in _RULES:
        raise ValueError(f"rule_kind must be one of {sorted(_RULES)}, got {rule_kind!r}")
    kernels._check_shapes(a, b, x0)
    if a.device.type == "cpu":
        return resident_adapgm_plain(a, b, x0, gamma0, tol, maxit, prox_kind=prox_kind,
                                     p1=p1, p2=p2, rule_kind=rule_kind, momentum=momentum,
                                     record=record, obj_kind=obj_kind, m_true=m_true,
                                     cube_c=cube_c)
    if a.device.type != "cuda":
        raise ValueError(f"K2 runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch(a, b, x0, gamma0, tol, maxit, prox_kind, p1, p2, rule_kind, momentum,
                   record, obj_kind, m_true, cube_c)


resident_adapgm.launches = 0


def resident_adapgm_l1(a, b, x0, gamma0, lam, tol, maxit):
    """Lasso specialization (g = lam * ||.||_1)."""
    return resident_adapgm(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=lam)


def resident_logreg_l1(x_mat, y, x0, gamma0, lam, tol, maxit, m_true=None,
                       rule_kind="adapgm", momentum=False, record=False):
    """Whole-solve sparse logistic regression (mean logistic + lam*||.||_1,
    bias folded as a trailing ones column; sparse_logreg/runme.jl:18-39).
    ``x_mat``: [X 1] with the ones column appended, zero-padded in rows
    and columns as the caller likes; ``m_true``: the unpadded row count (the
    mean's divisor: zero-padded rows add nothing to the gradient but must not
    count in the mean)."""
    return resident_adapgm(x_mat, y, x0, gamma0, tol, maxit, prox_kind="l1", p1=lam,
                           rule_kind=rule_kind, momentum=momentum, obj_kind="logreg",
                           m_true=m_true, record=record)


# -- K2c, the rule sweep --------------------------------------------------------------


def rule_rows(specs, tol=None, maxit=None):
    """Build the (R, 5) rows array for ``resident_rule_sweep`` from
    [(gamma0, rule_kind, momentum), ...] or
    [(gamma0, rule_kind, momentum, tol, cap), ...] specs; 3-tuples take
    the given tol/maxit, which are then required (a maxit-0 row would
    solve nothing)."""
    out = []
    for spec in specs:
        if len(spec) == 3:
            if tol is None or maxit is None:
                raise ValueError(
                    "3-tuple specs need explicit tol= and maxit= (pass the "
                    "launch values; a maxit-0 row would solve nothing)")
            g, r, mom = spec
            t, cap = tol, maxit
        else:
            g, r, mom, t, cap = spec
        out.append([g, _RULE_IDX[r], 1.0 if mom else 0.0, t, cap])
    return np.asarray(out)


def _sweep_rows(rows, maxit, dtype):
    """The rows table in the iterate dtype on the host, as the JAX sweep
    casts it, after checking every row. A cap past ``maxit`` is refused: the
    JAX kernel drops those history writes silently, the CUDA kernel would
    write past its buffers."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.as_tensor(np.asarray(rows))
    rows = rows.to(device="cpu", dtype=dtype)
    if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != 5:
        raise ValueError(f"rows must be (R >= 1, 5) [gamma0, rule_idx, momentum, tol, cap], "
                         f"got {tuple(rows.shape)}")
    rule, cap = rows[:, 1], rows[:, 4]
    if not bool(((rule == 0) | (rule == 1) | (rule == 2)).all()):
        raise ValueError(f"rule_idx must be 0 (fixed), 1 (mm) or 2 (adapgm), got "
                         f"{rule.tolist()}")
    if not bool(((cap >= 0) & (cap <= maxit) & (cap == torch.round(cap))).all()):
        raise ValueError(f"every row's cap must be an integer in [0, maxit={maxit}], got "
                         f"{cap.tolist()}")
    return rows


def resident_rule_sweep_plain(a, b, x0, rows, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                              obj_kind="ls", m_true=None, cube_c=0.0):
    """The plain version of the sweep: one plain solve a row, with that row's
    gamma0, rule, momentum flag, tol and cap, in record mode; histories are
    zero-padded to ``maxit``. Returns what ``resident_rule_sweep`` returns."""
    rows = _sweep_rows(rows, maxit, x0.dtype)
    outs = [resident_adapgm_plain(a, b, x0, g0, t, int(cap), prox_kind, p1, p2,
                                  rule_kind=_RULE_OF_IDX[int(r)], momentum=mom > 0,
                                  record=True, obj_kind=obj_kind, m_true=m_true,
                                  cube_c=cube_c)
            for g0, r, mom, t, cap in rows.tolist()]
    hists = tuple(torch.stack([F.pad(o[k], (0, maxit - o[k].shape[0])) for o in outs])
                  for k in (4, 5, 6))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4)) + (hists,)


# K2c's plan (csrc/resident_pg.cu): the rows go in lockstep groups of K2C_GROUP in table
# order; a phase's dots take the running rows two at a time over each row of A or A^T.
K2C_GROUP = 8             # kGroup
K2C_PARTS = 8             # kParts: partial sums a row a CTA
K2C_WARPS = 16            # kWarps: warps a CTA (512 threads)
K2C_PLAN_KEYS = ("groups", "syncs", "row_passes", "grid", "scratch", "a_bytes")


def k2c_plan(rows, m, n, itemsize, sms):
    """K2c's launch for the (R, 5) ``rows`` table ([gamma0, rule_idx, momentum, tol, cap])
    at (m, n) with A's ``itemsize`` (4: f32, 2: bf16) on a card of ``sms`` SMs: a dict of
    ``K2C_PLAN_KEYS``.

    * ``groups``: the rows' indices in lockstep groups of at most K2C_GROUP, in table order;
    * ``syncs``: per group, the grid syncs of a lockstep iteration: 4 while a momentum row
      runs (its P1' at x_new), else 3, for the whole group;
    * ``row_passes``: per group, the passes a phase takes over each row of A (or A^T) while
      every row of the group runs: one a pair of rows (the first from the L2, the rest from
      the L1);
    * ``grid``: K2's grid for the shape, min(ceil(max(m, n) / 16), sms);
    * ``scratch``: the shapes the wrapper allocates: K2's scratch once for each row of the
      first (largest) group, ``part`` K2C_PARTS x that x ``sms`` floats;
    * ``a_bytes``: the bytes of A, which a phase reads from the L2 once for the group.

    Only ``grid`` and the ``part`` scratch follow ``sms``. The arithmetic of each row does
    not follow the plan at all: K2c's row g runs K2's sums in K2's order on K2's grid, so its
    bits depend on (m, n, dtype) and its own arguments, not on its group, its place there or
    the rows beside it."""
    if itemsize not in (2, 4):
        raise ValueError(f"K2c stores A as float32 or bfloat16, got itemsize {itemsize}")
    if m < 1 or n < 1 or sms < 1:
        raise ValueError(f"K2c needs m, n, sms >= 1, got {m}, {n}, {sms}")
    table = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows, dtype=np.float64)
    if table.ndim != 2 or table.shape[0] < 1 or table.shape[1] != 5:
        raise ValueError(f"rows must be (R >= 1, 5), got {table.shape}")
    count = table.shape[0]
    groups = [list(range(s, min(count, s + K2C_GROUP))) for s in range(0, count, K2C_GROUP)]
    g0 = len(groups[0])
    return dict(groups=groups,
                syncs=[4 if any(table[j, 2] > 0 for j in grp) else 3 for grp in groups],
                row_passes=[-(-len(grp) // 2) for grp in groups],
                grid=min(-(-max(m, n) // K2C_WARPS), sms),
                scratch=dict(xs=(g0, 2, n), gs=(g0, 2, n), v=(g0, n), res=(g0, m),
                             part=g0 * K2C_PARTS * sms),
                a_bytes=m * n * itemsize)


def _launch_sweep(a, b, x0, rows, maxit, prox_kind, p1, p2, obj_kind, m_true, cube_c,
                  lib=None):
    """One K2c launch on checked inputs, from ``lib`` (default: the build of SOURCE), with
    K2's scratch once for each row of the largest group (``k2c_plan``'s ``scratch``)."""
    lib = lib or _library()
    dev = a.device
    m, n = a.shape
    count = rows.shape[0]
    with torch.cuda.device(dev):
        if lib.adaprox_resident_pg_group() != K2C_GROUP:
            raise RuntimeError("csrc/resident_pg.cu's kGroup differs from K2C_GROUP")
        # keep: the tensors behind args
        args, keep = _problem(lib.adaprox_resident_pg_parts(), a, b, x0, obj_kind, m_true,
                              cube_c, "K2c", copies=min(count, K2C_GROUP))
        rows_f, rows_i, x_out, stats, hist = _sweep_buffers(rows, maxit, n, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_pg_sweep(
            *args, rows_f.data_ptr(), rows_i.data_ptr(), count, x_out.data_ptr(),
            stats.data_ptr(), hist.data_ptr() if maxit else None, m, n, maxit, float(p1),
            float(p2), _PROX_IDX[prox_kind], stream)
    _raise_on(lib, err, "K2c launch")
    resident_rule_sweep.launches += 1
    return _sweep_result(x_out, stats, hist)


def _sweep_buffers(rows, maxit, n, dev):
    """K2c's checked rows table on the device, (gamma0, tol) as f32 and (rule, momentum,
    cap) as int32, and its outputs x_out (R, n), stats (R, 4), hist (R, 3, maxit)."""
    rows_f = rows[:, [0, 3]].to(device=dev, dtype=torch.float32).contiguous()
    rows_i = torch.stack([rows[:, 1], (rows[:, 2] > 0).to(rows.dtype), rows[:, 4]], 1)
    rows_i = rows_i.to(device=dev, dtype=torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    count = rows.shape[0]
    return (rows_f, rows_i, torch.empty((count, n), **f32), torch.empty((count, 4), **f32),
            torch.empty((count, 3, maxit), **f32))


def _sweep_result(x_out, stats, hist):
    return (x_out, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 3] > 0,
            (hist[:, 0], hist[:, 1], hist[:, 2]))


def resident_rule_sweep(a, b, x0, rows, tol, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                        cube_c=0.0, obj_kind="ls", m_true=None):
    """The whole rule menu of an experiment as ONE record-mode launch, for
    ``obj_kind`` "ls", "logreg" (with ``m_true``) or "cubic" (with ``cube_c``),
    as ``resident_adapgm``:
    ``rows`` is an (R, 5) array of [gamma0, rule_idx, momentum, tol, cap]
    (build it with ``rule_rows``; ``tol`` here is the launch's, which
    ``rule_rows`` puts into 3-tuple rows). ``maxit`` sizes the history
    buffers and must be >= every row's cap. Returns (x (R, n), numit (R,),
    norm_res (R,), converged (R,), (hg, hr, ho) each (R, maxit)); feed each
    row to ``resident_records`` with its own momentum flag.

    CPU tensors take the plain version; the iterates must have at least 32
    bits (the rows table rides their dtype). CUDA tensors launch K2c, with
    what K2 takes; each launch adds one to ``resident_rule_sweep.launches``.
    Row j equals ``resident_adapgm`` with row j's arguments."""
    del tol  # each row carries its own tol
    if torch.finfo(x0.dtype).bits < 32:
        raise ValueError(f"resident_rule_sweep needs >= 32-bit iterates (got {x0.dtype}): the "
                         "rows table's cap and tol columns would be quantized")
    _check_menu("resident_rule_sweep", a, prox_kind, obj_kind)
    kernels._check_shapes(a, b, x0)
    if a.device.type == "cpu":
        return resident_rule_sweep_plain(a, b, x0, rows, maxit, prox_kind, p1, p2, obj_kind,
                                         m_true, cube_c)
    if a.device.type != "cuda":
        raise ValueError(f"K2c runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch_sweep(a, b, x0, _sweep_rows(rows, maxit, x0.dtype), maxit, prox_kind, p1,
                         p2, obj_kind, m_true, cube_c)


resident_rule_sweep.launches = 0


# -- K2b, the batch of independent problems ---------------------------------------------


def _batch_scal(scal, bsz, dtype):
    """The (B, 5) [gamma0, tol, p1, p2, cube_c] table in the iterate dtype, a
    (B, 4) table given a zero cube_c column, as the JAX entry pads it."""
    scal = torch.as_tensor(scal)
    if scal.ndim != 2 or scal.shape[0] != bsz or scal.shape[1] not in (4, 5):
        raise ValueError(f"scal must be (B={bsz}, 4) [gamma0, tol, p1, p2] or (B, 5) with a "
                         f"trailing cube_c, got {tuple(scal.shape)}")
    if scal.shape[1] == 4:
        scal = torch.cat([scal, torch.zeros((bsz, 1), dtype=scal.dtype, device=scal.device)], 1)
    return scal.to(dtype)


def _check_batch(a, b, x0, scal, prox_kind, rule_kind, obj_kind):
    if rule_kind == "dynamic":
        raise ValueError("resident_adapgm_batch: rule_kind='dynamic' takes each row's rule from "
                         "a rows table, which only resident_rule_sweep has (as in the JAX "
                         "package); pass 'fixed', 'mm' or 'adapgm'")
    if rule_kind not in _RULES:
        raise ValueError(f"rule_kind must be one of {sorted(_RULES)}, got {rule_kind!r}")
    if a.ndim != 3 or b.ndim != 2 or x0.ndim != 2:
        raise ValueError(f"need a (B, m, n), b (B, m), x0 (B, n); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(x0.shape)}")
    bsz = a.shape[0]
    if bsz < 1 or b.shape[0] != bsz or x0.shape[0] != bsz:
        raise ValueError(f"need B >= 1 instances in a, b and x0 alike; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(x0.shape)}")
    _check_menu("resident_adapgm_batch", a[0], prox_kind, obj_kind)
    kernels._check_shapes(a[0], b[0], x0[0])
    return _batch_scal(scal, bsz, x0.dtype)


def resident_adapgm_batch_plain(a, b, x0, scal, maxit, prox_kind="l1", rule_kind="adapgm",
                                momentum=False, obj_kind="ls", m_true=None):
    """The plain version of the batch: one ``resident_adapgm_plain`` solve an
    instance with its row of ``scal``, stacked. Returns what
    ``resident_adapgm_batch`` returns."""
    scal = _check_batch(a, b, x0, scal, prox_kind, rule_kind, obj_kind)
    outs = [resident_adapgm_plain(a[i], b[i], x0[i], sc[0], sc[1], maxit, prox_kind=prox_kind,
                                  p1=sc[2], p2=sc[3], rule_kind=rule_kind, momentum=momentum,
                                  obj_kind=obj_kind, m_true=m_true, cube_c=sc[4])
            for i, sc in enumerate(scal.to(x0.device))]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))


def _launch_batch(a, b, x0, scal, maxit, prox_kind, rule_kind, momentum, obj_kind, m_true,
                  lib=None):
    """One K2b launch on checked inputs, from ``lib`` (default: the build of SOURCE)."""
    lib = lib or _library()
    dev = a.device
    bsz, m, n = a.shape
    with torch.cuda.device(dev):
        # keep: the tensors behind args; each instance's cube_c is its scal row's
        args, keep = _problem(lib.adaprox_resident_pg_parts(), a, b, x0, obj_kind, m_true,
                              0.0, "K2b")
        stride = 0 if a.stride(0) == 0 else m * n  # A's and A^T's, in elements
        f32 = dict(dtype=torch.float32, device=dev)
        scal_d = scal.to(**f32).contiguous()
        x_out, stats = torch.empty((bsz, n), **f32), torch.empty((bsz, 4), **f32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_pg_batch(
            *args, stride, stride, scal_d.data_ptr(), bsz, x_out.data_ptr(), stats.data_ptr(),
            m, n, maxit, _PROX_IDX[prox_kind], _RULE_IDX[rule_kind], int(momentum), stream)
    _raise_on(lib, err, "K2b launch")
    resident_adapgm_batch.launches += 1
    return x_out, stats[:, 0].to(torch.int32), stats[:, 1], stats[:, 3] > 0


def resident_adapgm_batch(a, b, x0, scal, maxit, prox_kind="l1", rule_kind="adapgm",
                          momentum=False, obj_kind="ls", m_true=None):
    """B independent whole solves in one launch (K2b): instance i solves
    ``resident_adapgm``'s problem with ``a[i]``, ``b[i]``, ``x0[i]`` and the
    scalars of ``scal[i]``, with the launch's ``maxit``, prox, rule (or
    ``momentum``), objective and ``m_true``; there is no record mode.

    a: (B, m, n); b: (B, m); x0: (B, n); scal: (B, 4) rows of
    [gamma0, tol, p1, p2], or (B, 5) with a trailing cube_c column (a (B, 4)
    table gets cube_c = 0); it is cast to x0's dtype. Returns (x (B, n),
    numit (B,) int32, norm_res (B,), converged (B,) bool).

    One A for every instance, as a regularization path has, is passed as
    ``a0.expand(B, m, n)``: a batch stride of 0. The kernel then reads that one
    copy (one A^T is formed, nothing is materialized), and the result equals
    that of the materialized (B, m, n) A bit for bit.

    CPU tensors take the plain version (one plain solve an instance). CUDA
    tensors launch K2b, with what K2 takes (b and x0 contiguous, A contiguous
    or expanded from one contiguous (m, n) A); each launch adds one to
    ``resident_adapgm_batch.launches``. Instance i equals ``resident_adapgm``
    with its arguments bit for bit."""
    scal = _check_batch(a, b, x0, scal, prox_kind, rule_kind, obj_kind)
    if a.device.type == "cpu":
        return resident_adapgm_batch_plain(a, b, x0, scal, maxit, prox_kind, rule_kind,
                                           momentum, obj_kind, m_true)
    if a.device.type != "cuda":
        raise ValueError(f"K2b runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch_batch(a, b, x0, scal, maxit, prox_kind, rule_kind, momentum, obj_kind,
                         m_true)


resident_adapgm_batch.launches = 0


def resident_records(numit, gamma_hist, res_hist, obj_hist, *, maxit, momentum=False):
    """``Records`` from the record-mode histories. The oracle counters are
    deterministic per iteration, so they are rebuilt here as the engines'
    record-time snapshots: at the record of iteration ``it``
      * PG loop: f_evals = grad_f_evals = it + 1 (the warm-up adds one) and
        prox_g_evals = it;
      * momentum (``fixed_nesterov``): all three equal ``it`` (no warm-up,
        the record is taken after the prox).
    Rows past ``numit`` are masked out by ``valid``."""
    dev = gamma_hist.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    z = torch.zeros(maxit, dtype=torch.int64, device=dev)
    f_evals = it if momentum else it + 1
    return Records(it=it, gamma=gamma_hist, sigma=torch.zeros_like(gamma_hist),
                   norm_res=res_hist, objective=obj_hist, f_evals=f_evals,
                   grad_f_evals=f_evals, prox_g_evals=it, prox_h_evals=z, A_evals=z,
                   At_evals=z, valid=it <= torch.as_tensor(numit, device=dev))
