"""The fused oracles: K1, least squares (f = 0.5 ||A x - b||^2 and
grad = A'(A x - b)), and K3, the mean logistic loss (f and its gradient in
the weights and the bias), each in one call.

Counterparts of ``adaprox_tpu/ops/kernels.py::fused_ls_value_grad`` and
``fused_logistic_value_grad`` (Pallas TPU kernels). Here each kernel is
hand-written CUDA C++ for Hopper (``csrc/fused_ls.cu``,
``csrc/fused_logistic.cu``), built with nvcc for ``sm_90a`` at first use into
``adaprox_tpu_torch/_build/`` (keyed on the source's content hash), loaded
with ctypes (one library handle a source) and launched on the current
stream.

Both wrappers dispatch on where their tensors lie: CPU tensors take the plain
versions ``ls_value_grad_plain`` / ``logistic_value_grad_plain``; CUDA
tensors launch the kernel or raise. There is no fall-back from CUDA to the
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from .linops import acc_dtype

__all__ = ["fused_ls_value_grad", "ls_value_grad_plain", "fused_logistic_value_grad",
           "logistic_value_grad_plain", "logistic_terms", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_ls.cu"
LOGISTIC_SOURCE = _PKG / "csrc" / "fused_logistic.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}  # (source, flags) -> the loaded library
_lib_lock = threading.Lock()


def ls_value_grad_plain(a, b, x):
    """The plain two-matmul version (counterpart of ``ls_value_grad_xla``):
    res = A x - b, grad = A' res, accumulated in the iterate dtype (bf16
    storage is upcast to it). Two passes over A."""
    acc = acc_dtype(a, x)
    a = a.to(acc)
    res = torch.mv(a, x.to(acc)) - b.to(acc)
    return 0.5 * torch.sum(res * res), torch.mv(a.t(), res)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not path.exists():
        raise RuntimeError("nvcc not found: the kernels are built from csrc/*.cu "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return str(path)


def build_library(source=SOURCE, flags=NVCC_FLAGS):
    """Compile the CUDA source ``source`` (K1's by default; K3's is
    ``LOGISTIC_SOURCE``) into a shared library with nvcc ``flags`` unless the
    build for this exact source, the headers beside it (``csrc/*.cuh``) and
    this flag set exists already. Returns the path; nvcc's
    register/shared-memory report is kept beside it as ``.log``."""
    source = Path(source)
    src = source.read_bytes() + b"".join(h.read_bytes()
                                         for h in sorted(source.parent.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library(source, flags, signatures):
    """The ctypes handle of ``source`` built with ``flags`` (``build_library``),
    loaded once a process. ``signatures`` maps each C entry's name to its
    (argtypes, restype)."""
    key = (str(source), tuple(flags))
    with _lib_lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build_library(source, flags)))
            for name, (argtypes, restype) in signatures.items():
                entry = getattr(lib, name)
                entry.argtypes, entry.restype = argtypes, restype
            _libs[key] = lib
        return _libs[key]


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library():
    return load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_fused_ls": ([_P, _I, _I, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P], _I),
        "adaprox_fused_ls_rows_per_step": ([_I], _I),
        "adaprox_cuda_error_string": ([_I], ctypes.c_char_p)})


def _check_shapes(a, b, x):
    if a.ndim != 2 or b.ndim != 1 or x.ndim != 1:
        raise ValueError(f"need a (m, n), b (m,), x (n,); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(x.shape)}")
    m, n = a.shape
    if b.shape[0] != m or x.shape[0] != n:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"x {tuple(x.shape)}")
    if not (a.device == b.device == x.device):
        raise ValueError(f"a, b, x on different devices: {a.device}, {b.device}, {x.device}")


def _grid(m, rows_per_step, device):
    """One CTA per SM (the persistent grid), at most one per block of rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-m // rows_per_step), sms)


def fused_ls_value_grad(a, b, x):
    """(f, grad) of 0.5 ||A x - b||^2. ``a`` (m, n), ``b`` (m,), ``x`` (n,).

    CPU tensors: the plain version, any float dtype. CUDA tensors: the K1
    kernel; ``a`` f32 or bf16, ``b`` and ``x`` f32, all contiguous, any
    m, n >= 1; returns a 0-d f32 ``f`` and an (n,) f32 ``grad``. Anything else
    raises. Each kernel launch adds one to ``fused_ls_value_grad.launches``."""
    _check_shapes(a, b, x)
    if a.device.type == "cpu":
        return ls_value_grad_plain(a, b, x)
    if a.device.type != "cuda":
        raise ValueError(f"K1 runs on CPU (plain version) or CUDA tensors, not {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K1 stores A as float32 or bfloat16 on CUDA, got {a.dtype}")
    if b.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 b and x on CUDA, got {b.dtype}, {x.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and x.is_contiguous()):
        raise ValueError("K1 needs contiguous a, b and x")
    m, n = a.shape
    if m < 1 or n < 1:
        raise ValueError(f"K1 needs m, n >= 1, got {tuple(a.shape)}")
    lib = _library()
    bf16 = a.dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    if n % vec or a.data_ptr() % 16 or x.data_ptr() % 16:
        vec = 1
    grid = _grid(m, lib.adaprox_fused_ls_rows_per_step(int(bf16)), a.device)
    f_part = torch.empty(grid, dtype=torch.float32, device=a.device)
    g_part = torch.empty((grid, n), dtype=torch.float32, device=a.device)
    f = torch.empty((), dtype=torch.float32, device=a.device)
    grad = torch.empty(n, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.adaprox_fused_ls(
            a.data_ptr(), int(bf16), vec, b.data_ptr(), x.data_ptr(), m, n, grid,
            f_part.data_ptr(), g_part.data_ptr(), f.data_ptr(), grad.data_ptr(), stream)
    if err:
        msg = lib.adaprox_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    fused_ls_value_grad.launches += 1
    return f, grad


fused_ls_value_grad.launches = 0


# -- K3, the fused logistic oracle ----------------------------------------------------


def logistic_terms(logits, y):
    """The rows of the logistic loss at ``logits``: the terms
    (y - 1) z - softplus(-z) whose mean is -f (softplus(-z) computed stably,
    as logaddexp(0, -z)), and the probabilities sigmoid(z)."""
    softplus_neg = torch.logaddexp(torch.zeros_like(logits), -logits)
    return (y - 1.0) * logits - softplus_neg, 1.0 / (1.0 + torch.exp(-logits))


def logistic_value_grad_plain(x_mat, y, w, w_bias):
    """The plain version (counterpart of ``logistic_value_grad_xla``):
    z = X w + w_b, f = -mean((y - 1) z - softplus(-z)), grad_w =
    X'(sigmoid(z) - y)/m, grad_b = mean(sigmoid(z) - y), accumulated in the
    dtype of ``w`` (bf16 storage of X is upcast to it). Two passes over X."""
    acc = w.dtype
    x_mat = x_mat.to(acc)
    y = y.to(acc)
    terms, probs = logistic_terms(torch.mv(x_mat, w) + w_bias, y)
    diff = probs - y
    return -torch.mean(terms), torch.mv(x_mat.t(), diff) / y.shape[0], torch.mean(diff)


def _logistic_library():
    return load_library(LOGISTIC_SOURCE, NVCC_FLAGS, {
        "adaprox_fused_logistic": ([_P, _I, _I, _P, _P, _P, _LL, _LL, _I] + [_P] * 7, _I),
        "adaprox_fused_logistic_rows_per_step": ([_I], _I),
        "adaprox_fused_logistic_error_string": ([_I], ctypes.c_char_p)})


def fused_logistic_value_grad(x_mat, y, w, w_bias):
    """(f, grad_w, grad_bias) of the mean logistic loss with logits
    X w + w_bias. ``x_mat`` (m, n), ``y`` (m,) labels in {0, 1}, ``w`` (n,),
    ``w_bias`` a 0-d tensor.

    CPU tensors: the plain version, any float dtype. CUDA tensors: the K3
    kernel; ``x_mat`` f32 or bf16, ``y``, ``w`` and ``w_bias`` f32, all
    contiguous, any m, n >= 1; returns a 0-d f32 ``f``, an (n,) f32 ``grad_w``
    and a 0-d f32 ``grad_bias``. Anything else raises. Each kernel launch adds
    one to ``fused_logistic_value_grad.launches``."""
    if x_mat.ndim != 2 or y.ndim != 1 or w.ndim != 1 or w_bias.ndim != 0:
        raise ValueError(f"need x_mat (m, n), y (m,), w (n,), w_bias (); got "
                         f"{tuple(x_mat.shape)}, {tuple(y.shape)}, {tuple(w.shape)}, "
                         f"{tuple(w_bias.shape)}")
    m, n = x_mat.shape
    if y.shape[0] != m or w.shape[0] != n:
        raise ValueError(f"shape mismatch: x_mat {tuple(x_mat.shape)}, y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x_mat.device == y.device == w.device == w_bias.device):
        raise ValueError(f"x_mat, y, w, w_bias on different devices: {x_mat.device}, "
                         f"{y.device}, {w.device}, {w_bias.device}")
    if x_mat.device.type == "cpu":
        return logistic_value_grad_plain(x_mat, y, w, w_bias)
    if x_mat.device.type != "cuda":
        raise ValueError(f"K3 runs on CPU (plain version) or CUDA tensors, not {x_mat.device}")
    if x_mat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 stores X as float32 or bfloat16 on CUDA, got {x_mat.dtype}")
    if any(t.dtype != torch.float32 for t in (y, w, w_bias)):
        raise TypeError(f"K3 takes float32 y, w and w_bias on CUDA, got {y.dtype}, {w.dtype}, "
                        f"{w_bias.dtype}")
    if not (x_mat.is_contiguous() and y.is_contiguous() and w.is_contiguous()):
        raise ValueError("K3 needs contiguous x_mat, y and w")
    if m < 1 or n < 1:
        raise ValueError(f"K3 needs m, n >= 1, got {tuple(x_mat.shape)}")
    lib = _logistic_library()
    bf16 = x_mat.dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    if n % vec or x_mat.data_ptr() % 16 or w.data_ptr() % 16:
        vec = 1
    grid = _grid(m, lib.adaprox_fused_logistic_rows_per_step(int(bf16)), x_mat.device)
    f32 = dict(dtype=torch.float32, device=x_mat.device)
    loss_part, d_part = torch.empty(grid, **f32), torch.empty(grid, **f32)
    g_part = torch.empty((grid, n), **f32)
    f, gw, gb = torch.empty((), **f32), torch.empty(n, **f32), torch.empty((), **f32)
    with torch.cuda.device(x_mat.device):
        stream = torch.cuda.current_stream(x_mat.device).cuda_stream
        err = lib.adaprox_fused_logistic(
            x_mat.data_ptr(), int(bf16), vec, y.data_ptr(), w.data_ptr(), w_bias.data_ptr(), m,
            n, grid, loss_part.data_ptr(), d_part.data_ptr(), g_part.data_ptr(), f.data_ptr(),
            gw.data_ptr(), gb.data_ptr(), stream)
    if err:
        msg = lib.adaprox_fused_logistic_error_string(err).decode()
        raise RuntimeError(f"K3 launch failed: CUDA error {err} ({msg})")
    fused_logistic_value_grad.launches += 1
    return f, gw, gb


fused_logistic_value_grad.launches = 0
