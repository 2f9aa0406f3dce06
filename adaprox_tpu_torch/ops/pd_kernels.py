"""K5, the fused one-pass primal update of the primal-dual iteration
(counterpart of ``adaprox_tpu/ops/pd_kernels.py``).

The primal-dual iteration reads the coupling matrix A twice: A x for the dual
update, and A'y for the primal one. Half 2 of iteration k and half 1 of
iteration k + 1 fuse: for each coordinate i of x,

    aty_i = A'_i y ;  v_i = x_i - gamma (grad_i + aty_i) ;  xn_i = prox_{gamma g}(v_i)
    A xn += A'_i' xn_i        (the same row of A': the next iteration's A x)

one pass over A' instead of two, because the primal prox is separable (the
kernel's menu: l1, box, zero, elastic). The matrix is taken TRANSPOSED, ``at``
(n, m), so both reductions run over contiguous rows.

``fused_pd_primal_update`` dispatches on where its tensors lie: CPU tensors take
the plain version ``pd_primal_update_plain`` (two ``torch.mv`` and the prox, the
counterpart of ``pd_primal_update_xla``); CUDA tensors launch the hand-written
Hopper kernel (``csrc/fused_pd.cu``, built with nvcc for ``sm_90a`` at first use
and loaded with ctypes) or raise. There is no fall-back from CUDA to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels

__all__ = ["fused_pd_primal_update", "pd_primal_update_plain", "pd_fusable", "PROX_KINDS",
           "build_library"]

SOURCE = kernels._PKG / "csrc" / "fused_pd.cu"
# -fmad=false: v and the prox round after each operation, as the plain version's
# tensor ops do (the kernel's dot products use explicit fmaf)
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
# the kernel's prox menu, in the order of csrc/fused_pd.cu's kinds
PROX_KINDS = ("l1", "box", "zero", "elastic")
LANE = 128  # the JAX kernel's lane width over m


def sublane(itemsize):
    """The JAX kernel's row-tile unit over n: 8 rows for 4- and 8-byte storage,
    16 for bf16 (its (16, 128) register tiles). Its row tile is a multiple of
    this that divides n, so n divides into tiles exactly when this divides n."""
    return 8 if itemsize >= 4 else 16


def pd_fusable(at):
    """Whether the JAX kernel takes ``at`` (n, m) compiled: n a multiple of 8 (16
    for bf16) and m a multiple of 128. The fused solver pads to this shape, so it
    solves the same padded problem on either side."""
    n, m = at.shape
    return n % sublane(at.element_size()) == 0 and m % LANE == 0


def _soft(v, thr):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)


def _prox_l1(v, gamma, p1, p2):
    return _soft(v, p1 * gamma)


def _prox_box(v, gamma, p1, p2):
    # jnp.clip: min(max(v, lo), hi), NaN in NaN out
    return torch.minimum(torch.maximum(v, p1), p2)


def _prox_zero(v, gamma, p1, p2):
    return v


def _prox_elastic(v, gamma, p1, p2):
    # argmin 0.5 ||z - v||^2 + gamma (p1 |z| + p2 / 2 z^2)
    return _soft(v, p1 * gamma) / (1.0 + gamma * p2)


_PROX = {"l1": _prox_l1, "box": _prox_box, "zero": _prox_zero, "elastic": _prox_elastic}


def pd_primal_update_plain(at, y, x, grad, gamma, p1=0.0, p2=0.0, prox_kind="l1"):
    """The plain two-pass version (counterpart of ``pd_primal_update_xla``):
    (A'y, v, x_new, A x_new) from the transposed ``at`` (n, m), accumulated in
    ``x``'s dtype (bf16 storage is upcast to it)."""
    acc = x.dtype
    at = at.to(acc)
    p1 = torch.as_tensor(p1, dtype=acc, device=x.device)
    p2 = torch.as_tensor(p2, dtype=acc, device=x.device)
    aty = torch.mv(at, y.to(acc))
    v = x - gamma * (grad + aty)
    x_new = _PROX[prox_kind](v, gamma, p1, p2)
    return aty, v, x_new, torch.mv(at.t(), x_new)


def build_library():
    """Compile ``csrc/fused_pd.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_fused_pd": ([p, i, i, i, p, p, p, p, f, f, ll, ll, i, p, p, p, p, p, p], i),
        "adaprox_fused_pd_rows_per_step": ([i], i),
        "adaprox_fused_pd_error_string": ([i], ctypes.c_char_p)})


def _check(at, y, x, grad, prox_kind):
    if at.ndim != 2 or y.ndim != 1 or x.ndim != 1 or grad.ndim != 1:
        raise ValueError(f"need at (n, m), y (m,), x (n,), grad (n,); got {tuple(at.shape)}, "
                         f"{tuple(y.shape)}, {tuple(x.shape)}, {tuple(grad.shape)}")
    n, m = at.shape
    if y.shape[0] != m or x.shape[0] != n or grad.shape[0] != n:
        raise ValueError(f"shape mismatch: at {tuple(at.shape)}, y {tuple(y.shape)}, x "
                         f"{tuple(x.shape)}, grad {tuple(grad.shape)}")
    if not (at.device == y.device == x.device == grad.device):
        raise ValueError(f"at, y, x, grad on different devices: {at.device}, {y.device}, "
                         f"{x.device}, {grad.device}")
    if prox_kind not in _PROX:
        raise ValueError(f"prox_kind must be one of {PROX_KINDS}, got {prox_kind!r}")
    if n < 1 or n % sublane(at.element_size()):
        # the JAX kernel refuses such an n in every mode: a row tile that does not
        # divide n would skip the tail coordinates
        raise ValueError(f"at shape {tuple(at.shape)} not divisible into "
                         f"({sublane(at.element_size())}, {m}) tiles; see pd_fusable")


def fused_pd_primal_update(at, y, x, grad, gamma, p1=0.0, p2=0.0, prox_kind="l1"):
    """One pass over A' for the primal half-step: returns (A'y (n,), v (n,),
    x_new (n,), A x_new (m,)) with v = x - gamma (grad + A'y) and x_new =
    prox_{gamma g}(v) of the menu's ``prox_kind``: "l1" (p1 = lam), "box"
    (p1, p2 = lo, hi), "elastic" (p1, p2 = l1, l2) or "zero". ``at`` is the
    TRANSPOSED coupling matrix (n, m); n must be a multiple of 8 (16 for bf16
    storage), as the JAX kernel requires in every mode; any m >= 1.

    CPU tensors: the plain version, any float dtype. CUDA tensors: the K5 kernel;
    ``at`` f32 or bf16, ``y``, ``x``, ``grad`` f32, all contiguous; ``gamma`` a
    0-d f32 tensor on the card (read there, never on the host) or a number;
    ``p1``, ``p2`` numbers. Returns f32 tensors. Anything else raises. Each kernel
    launch adds one to ``fused_pd_primal_update.launches``."""
    _check(at, y, x, grad, prox_kind)
    if at.device.type == "cpu":
        return pd_primal_update_plain(at, y, x, grad, gamma, p1, p2, prox_kind)
    if at.device.type != "cuda":
        raise ValueError(f"K5 runs on CPU (plain version) or CUDA tensors, not {at.device}")
    if at.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K5 stores A' as float32 or bfloat16 on CUDA, got {at.dtype}")
    if any(t.dtype != torch.float32 for t in (y, x, grad)):
        raise TypeError(f"K5 takes float32 y, x and grad on CUDA, got {y.dtype}, {x.dtype}, "
                        f"{grad.dtype}")
    if not (at.is_contiguous() and y.is_contiguous() and x.is_contiguous()
            and grad.is_contiguous()):
        raise ValueError("K5 needs contiguous at, y, x and grad")
    if not isinstance(gamma, torch.Tensor):
        gamma = torch.full((), float(gamma), dtype=torch.float32, device=at.device)
    if gamma.numel() != 1 or gamma.dtype != torch.float32 or gamma.device != at.device:
        raise TypeError(f"K5 takes gamma as one float32 on {at.device}, got {gamma.dtype} "
                        f"{tuple(gamma.shape)} on {gamma.device}")
    gamma = gamma.contiguous()
    p1, p2 = float(p1), float(p2)  # fixed for a solve: the fused solver passes floats
    n, m = at.shape
    lib = _library()
    bf16 = at.dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    if m % vec or at.data_ptr() % 16 or y.data_ptr() % 16:
        vec = 1
    rows = lib.adaprox_fused_pd_rows_per_step(int(bf16))
    grid = kernels._grid(n, rows, at.device)
    f32 = dict(dtype=torch.float32, device=at.device)
    part = torch.empty((grid, m), **f32)
    aty, v, xn = torch.empty(n, **f32), torch.empty(n, **f32), torch.empty(n, **f32)
    axn = torch.empty(m, **f32)
    with torch.cuda.device(at.device):
        stream = torch.cuda.current_stream(at.device).cuda_stream
        err = lib.adaprox_fused_pd(
            at.data_ptr(), int(bf16), vec, PROX_KINDS.index(prox_kind), y.data_ptr(),
            x.data_ptr(), grad.data_ptr(), gamma.data_ptr(), p1, p2, n, m, grid,
            part.data_ptr(), aty.data_ptr(), v.data_ptr(), xn.data_ptr(), axn.data_ptr(),
            stream)
    if err:
        msg = lib.adaprox_fused_pd_error_string(err).decode()
        raise RuntimeError(f"K5 launch failed: CUDA error {err} ({msg})")
    fused_pd_primal_update.launches += 1
    return aty, v, xn, axn


fused_pd_primal_update.launches = 0
