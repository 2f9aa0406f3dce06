"""K7d, the whole-solve Condat-Vu kernel of the f = 0 composite family: the
square-root lasso and the least absolute deviation,

    min_x lam ||x||_1 + h(A x),   h = Translate(inner, -bv),   inner = NormL2 or NormL1,

with fixed steps (gamma, sigma) (experiments/square_root_lasso/runme.jl:37-47).

Counterpart of ``adaprox_tpu/ops/resident.py:1529-1638, 2056-2093``:
``resident_condat_vu`` (K7d, ``_cv_kernel[_rec]`` over ``_cv_core`` on
``_f0_ops``); its records are ``resident_pd.resident_cv_records``, one function
in JAX too. Here the entry reaches a hand-written CUDA C++ routine for Hopper
(``csrc/resident_cv.cu`` on ``csrc/resident_f0.cuh``): one cooperative launch
for the whole early-exit solve, built with nvcc for ``sm_90a`` at first use and
loaded with ctypes.

The entry dispatches on where its tensors lie: CPU tensors take the plain
version ``resident_condat_vu_plain`` (``_cv_core`` line by line, one
host-checked iteration at a time); CUDA tensors launch the kernel or raise. A
may be stored bf16; the iterates and scalars follow ``bv``'s dtype. Zero
padding is exact for this family: padded rows of A and bv and padded columns
of A leave their coordinates of y and x exactly 0, so the kernel takes no
unpadded size.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .resident_pd import _device, _scalars, _stats, hist_len

__all__ = ["resident_condat_vu", "resident_condat_vu_plain", "build_library", "H_KINDS"]

SOURCE = kernels._PKG / "csrc" / "resident_cv.cu"
# -fmad=false: every elementwise expression rounds after each operation, as the
# plain version's tensor ops do (the kernel's dot products use explicit fmaf)
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
# h's inner norm: "l2", the square-root lasso; "l1", the least absolute deviation
H_KINDS = ("l2", "l1")


def _check(a, bv, maxit, h_kind):
    if a.ndim != 2 or bv.ndim != 1 or a.shape[0] != bv.shape[0]:
        raise ValueError(f"resident_condat_vu: need a (m, n) and bv (m,); got "
                         f"{tuple(a.shape)}, {tuple(bv.shape)}")
    if a.device != bv.device:
        raise ValueError(f"resident_condat_vu: a and bv on different devices: {a.device}, "
                         f"{bv.device}")
    if h_kind not in H_KINDS:
        raise ValueError(f"resident_condat_vu: h_kind must be 'l2' or 'l1', got {h_kind!r}")
    if int(maxit) < 0:
        raise ValueError(f"resident_condat_vu: maxit must be >= 0, got {maxit}")


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


# -- the CUDA kernel --------------------------------------------------------------------


def build_library():
    """Compile ``csrc/resident_cv.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_resident_f0_parts": ([], i),
        # a, at, a_is_bf16, vec, m, n, bv, h_kind, lam, xs, v, at_y, y, ax, w, part,
        # part_len, gamma, sigma, tol, maxit, record, x_out, stats, hist, stream
        "adaprox_resident_condat_vu": ([p, p, i, i, ll, ll, p, i, f, p, p, p, p, p, p, p, ll, f,
                                        f, f, i, i, p, p, p, p], i),
        "adaprox_resident_cv_error_string": ([i], ctypes.c_char_p)})


def resident_condat_vu(a, bv, lam, gamma, sigma, tol, maxit, record=False, h_kind="l2"):
    """Whole-solve Condat-Vu for min lam ||x||_1 + ||A x - bv|| (``h_kind`` "l2")
    or lam ||x||_1 + ||A x - bv||_1 (``h_kind`` "l1") in one kernel launch, from
    x0 = 0, y0 = 0, with the fixed steps (gamma, sigma). ``a`` (m, n), ``bv`` (m,).

    Returns (x (n,), numit, norm_res, converged), plus ((norm_res_hist,
    objective_hist),) of shape (maxit,) when ``record=True`` (zero past numit; the
    objective lam ||x||_1 + h(A x) at the iteration's x); ``resident_pd.
    resident_cv_records`` turns them into ``Records``. On convergence x is the
    iterate at the check. CPU tensors take the plain version, any float dtype.
    CUDA tensors launch K7d (``csrc/resident_cv.cu``): ``a`` f32 or bf16, ``bv``
    f32, both contiguous; each launch adds one to ``resident_condat_vu.launches``."""
    if not _device("K7d", a):
        return resident_condat_vu_plain(a, bv, lam, gamma, sigma, tol, maxit, record, h_kind)
    _check(a, bv, maxit, h_kind)
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K7d stores A as float32 or bfloat16 on CUDA, got {a.dtype}")
    if bv.dtype != torch.float32:
        raise TypeError(f"K7d takes a float32 bv on CUDA, got {bv.dtype}")
    if not (a.is_contiguous() and bv.is_contiguous()):
        raise ValueError("K7d needs contiguous a and bv")
    lib = _library()
    dev = a.device
    m, n = a.shape
    maxit = int(maxit)
    with torch.cuda.device(dev):
        at = a.t().contiguous()
        # 16-byte loads when both layouts' rows are whole 16-byte groups
        vec = 8 if a.dtype == torch.bfloat16 else 4
        if m % vec or n % vec or a.data_ptr() % 16 or at.data_ptr() % 16:
            vec = 1
        f32 = dict(dtype=torch.float32, device=dev)
        xs, v, at_y = torch.empty((2, n), **f32), torch.empty(n, **f32), torch.empty(n, **f32)
        y, ax, w = torch.empty(m, **f32), torch.empty(m, **f32), torch.empty(m, **f32)
        # the launcher sizes the grid, at most one CTA per SM
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        part = torch.empty(lib.adaprox_resident_f0_parts() * sms, **f32)
        x_out, stats = torch.empty(n, **f32), torch.empty(3, **f32)
        hist = torch.empty((2, hist_len(maxit)), **f32) if record else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaprox_resident_condat_vu(
            a.data_ptr(), at.data_ptr(), int(a.dtype == torch.bfloat16), vec, m, n,
            bv.data_ptr(), H_KINDS.index(h_kind), float(lam), xs.data_ptr(), v.data_ptr(),
            at_y.data_ptr(), y.data_ptr(), ax.data_ptr(), w.data_ptr(), part.data_ptr(),
            part.numel(), float(gamma), float(sigma), float(tol), maxit, int(record),
            x_out.data_ptr(), stats.data_ptr(), hist.data_ptr() if record and maxit else None,
            stream)
    if err:
        msg = lib.adaprox_resident_cv_error_string(err).decode()
        raise RuntimeError(f"K7d launch failed: CUDA error {err} ({msg})")
    resident_condat_vu.launches += 1
    base = (x_out, stats[0].to(torch.int32), stats[1], stats[2] > 0)
    if record:
        return base + ((hist[0, :maxit], hist[1, :maxit]),)
    return base


resident_condat_vu.launches = 0
