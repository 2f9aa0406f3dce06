"""K2, the whole-solve kernel: a complete proximal-gradient solve of
0.5 ||A x - b||^2 + g(x) in one launch.

Counterpart of ``adaprox_tpu/ops/resident.py::resident_adapgm`` (the Pallas
TPU kernel over ``_solve_core``) for ``obj_kind="ls"`` without momentum:
step-size rules fixed / Malitsky-Mishchenko / AdaPGM, prox kinds l1 / box /
elastic / zero, and the record mode that returns per-iteration histories.
Here the kernel is hand-written CUDA C++ for Hopper
(``csrc/resident_pg.cu``): one cooperative launch with grid-wide barriers
between the phases of an iteration, built with nvcc for ``sm_90a`` at first
use and loaded with ctypes, like K1 (``ops/kernels.py``).

``resident_adapgm`` dispatches on where its tensors lie: CPU tensors take the
plain version ``resident_adapgm_plain`` (a Python loop over the same
iteration); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..solvers.common import Records
from . import kernels

__all__ = ["resident_supported", "resident_adapgm", "resident_adapgm_plain",
           "resident_adapgm_l1", "resident_records", "build_library"]

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
_PROX_IDX = {"l1": 0, "box": 1, "elastic": 2, "zero": 3}
_RULE_IDX = {"fixed": 0, "mm": 1, "adapgm": 2}


def resident_adapgm_plain(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                          rule_kind="adapgm", record=False):
    """The plain PyTorch version of the kernel: ``_solve_core``'s loop for
    ``obj_kind="ls"`` without momentum, one host-checked iteration at a time.
    Scalars are 0-d tensors in the iterate dtype; bf16 storage of ``a`` is
    upcast to it. Returns what ``resident_adapgm`` returns."""
    dt, dev = x0.dtype, x0.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    gamma0, tol, p1, p2 = (scalar(v) for v in (gamma0, tol, p1, p2))
    inf = scalar(math.inf)
    a = a.to(dt)
    b = b.to(dt)
    prox_fn, gval_fn, rule_fn = _PROX[prox_kind], _GVAL[prox_kind], _RULES[rule_kind]

    # warm-up (the engine's init)
    grad0 = torch.mv(a.t(), torch.mv(a, x0) - b)
    v = x0 - gamma0 * grad0
    x = prox_fn(v, gamma0, p1, p2)
    x_prev, grad_prev, ck_x = x0, grad0, x
    gamma = g1 = gamma0
    g0 = inf if rule_kind == "mm" else gamma0
    norm_res = inf
    hists = torch.zeros((3, maxit), dtype=dt, device=dev)
    it = 0
    while it < maxit and bool(norm_res > tol):  # a NaN residual stops
        res = torch.mv(a, x) - b
        grad = torch.mv(a.t(), res)
        primal = (v - x) / gamma + grad
        norm_res = torch.sqrt(torch.sum(primal * primal))
        dg = grad - grad_prev
        dx = x - x_prev
        gamma, g1, g0 = rule_fn(g1, g0, torch.sum(dg * dg), torch.sum(dg * dx),
                                torch.sum(dx * dx))
        if record:
            # objective at the CURRENT x, gamma the step just updated
            objective = 0.5 * torch.sum(res * res) + gval_fn(x, p1, p2)
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


_lib = None
_lib_lock = threading.Lock()


def build_library():
    """Compile ``csrc/resident_pg.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.adaprox_resident_pg_parts.argtypes = []
            lib.adaprox_resident_pg_parts.restype = i
            lib.adaprox_resident_pg.argtypes = [p, p, i, i, i, p, p, p, p, p, p, ll, p, p, p,
                                                ll, ll, i, f, f, f, f, i, i, i, p]
            lib.adaprox_resident_pg.restype = i
            lib.adaprox_resident_pg_error_string.argtypes = [i]
            lib.adaprox_resident_pg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _raise_on(lib, err, what):
    if err:
        msg = lib.adaprox_resident_pg_error_string(err).decode()
        raise RuntimeError(f"K2 {what} failed: CUDA error {err} ({msg})")


def _vec(rows_len, dtype, ptr):
    """Vector width of the kernel's 16-byte loads along rows of ``rows_len``."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return vec if rows_len % vec == 0 and ptr % 16 == 0 else 1


def _launch(a, b, x0, gamma0, tol, maxit, prox_kind, p1, p2, rule_kind, record):
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K2 stores A as float32 or bfloat16 on CUDA, got {a.dtype}")
    if b.dtype != torch.float32 or x0.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 b and x0 on CUDA, got {b.dtype}, {x0.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and x0.is_contiguous()):
        raise ValueError("K2 needs contiguous a, b and x0")
    m, n = a.shape
    if m < 1 or n < 1:
        raise ValueError(f"K2 needs m, n >= 1, got {tuple(a.shape)}")
    lib = _library()
    dev = a.device
    bf16 = int(a.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        # the second layout, made once per solve (it counts in the solve's time)
        at = a.t().contiguous()
        va, vt = _vec(n, a.dtype, a.data_ptr()), _vec(m, a.dtype, at.data_ptr())
        f32 = dict(dtype=torch.float32, device=dev)
        xs = torch.empty((2, n), **f32)
        xs[1].copy_(x0)
        gs = torch.empty((2, n), **f32)
        v, x_out = torch.empty(n, **f32), torch.empty(n, **f32)
        res = torch.empty(m, **f32)
        # the launcher sizes the grid, at most one CTA per SM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        part = torch.empty(lib.adaprox_resident_pg_parts() * sms, **f32)
        stats = torch.empty(4, **f32)
        hist = torch.empty((3, maxit), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_pg(
            a.data_ptr(), at.data_ptr(), bf16, va, vt, b.data_ptr(), xs.data_ptr(),
            gs.data_ptr(), v.data_ptr(), res.data_ptr(), part.data_ptr(), part.numel(),
            x_out.data_ptr(), stats.data_ptr(), hist.data_ptr() if record else None, m, n,
            maxit, float(gamma0), float(tol), float(p1), float(p2), _PROX_IDX[prox_kind],
            _RULE_IDX[rule_kind], int(record), stream)
    _raise_on(lib, err, "launch")
    resident_adapgm.launches += 1
    base = (x_out, stats[0].to(torch.int32), stats[1], stats[3] > 0)
    return base + tuple(hist) if record else base


def resident_adapgm(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=0.0, p2=0.0,
                    rule_kind="adapgm", momentum=False, obj_kind="ls", m_true=None,
                    record=False, cube_c=0.0):
    """Full proximal-gradient solve of 0.5||Ax-b||^2 + g(x) in one kernel
    launch, with g from the static prox menu ("l1", "box", "elastic",
    "zero") parameterized by (p1, p2) and the step-size rule from
    {"adapgm", "mm", "fixed"}.

    a: (m, n); b: (m,); x0: (n,). Returns (x, numit, norm_res, converged) as
    tensors on the input's device, plus (gamma_hist, norm_res_hist,
    objective_hist) of shape (maxit,) when ``record=True`` (zero past numit);
    ``resident_records`` turns those into ``Records``.

    CPU tensors take the plain version, any float dtype. CUDA tensors launch
    K2: ``a`` f32 or bf16, ``b`` and ``x0`` f32, all contiguous; each launch
    adds one to ``resident_adapgm.launches``. ``m_true`` and ``cube_c`` belong
    to the objectives not ported yet and are ignored for "ls", as in the JAX
    package."""
    del m_true, cube_c
    if momentum:
        raise NotImplementedError("resident_adapgm: momentum=True (the Nesterov body) is "
                                  "not ported yet; see ROADMAP.md §1")
    if obj_kind != "ls":
        raise NotImplementedError(f"resident_adapgm: obj_kind={obj_kind!r} is not ported "
                                  "yet (only 'ls'); see ROADMAP.md §1")
    if rule_kind == "dynamic":
        raise NotImplementedError("resident_adapgm: rule_kind='dynamic' belongs to the rule "
                                  "sweep (K2c), not ported yet; see ROADMAP.md §1")
    if rule_kind not in _RULES:
        raise ValueError(f"rule_kind must be one of {sorted(_RULES)}, got {rule_kind!r}")
    if prox_kind not in _PROX:
        raise ValueError(f"prox_kind must be one of {sorted(_PROX)}, got {prox_kind!r}")
    kernels._check_shapes(a, b, x0)
    if a.device.type == "cpu":
        return resident_adapgm_plain(a, b, x0, gamma0, tol, maxit, prox_kind=prox_kind,
                                     p1=p1, p2=p2, rule_kind=rule_kind, record=record)
    if a.device.type != "cuda":
        raise ValueError(f"K2 runs on CPU (plain version) or CUDA tensors, not {a.device}")
    return _launch(a, b, x0, gamma0, tol, maxit, prox_kind, p1, p2, rule_kind, record)


resident_adapgm.launches = 0


def resident_adapgm_l1(a, b, x0, gamma0, lam, tol, maxit):
    """Lasso specialization (g = lam * ||.||_1)."""
    return resident_adapgm(a, b, x0, gamma0, tol, maxit, prox_kind="l1", p1=lam)


def resident_records(numit, gamma_hist, res_hist, obj_hist, *, maxit):
    """``Records`` from the record-mode histories. The oracle counters are
    deterministic per iteration, so they are rebuilt here as the engine's
    record-time snapshots: at the record of iteration ``it``, f_evals =
    grad_f_evals = it + 1 (the warm-up adds one) and prox_g_evals = it.
    Rows past ``numit`` are masked out by ``valid``."""
    dev = gamma_hist.device
    it = torch.arange(1, maxit + 1, dtype=torch.int64, device=dev)
    z = torch.zeros(maxit, dtype=torch.int64, device=dev)
    return Records(it=it, gamma=gamma_hist, sigma=torch.zeros_like(gamma_hist),
                   norm_res=res_hist, objective=obj_hist, f_evals=it + 1,
                   grad_f_evals=it + 1, prox_g_evals=it, prox_h_evals=z, A_evals=z,
                   At_evals=z, valid=it <= torch.as_tensor(numit, device=dev))
