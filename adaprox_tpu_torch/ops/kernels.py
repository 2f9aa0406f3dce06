"""K1, the fused least-squares oracle: f = 0.5 ||A x - b||^2 and
grad = A'(A x - b) in one call.

Counterpart of ``adaprox_tpu/ops/kernels.py::fused_ls_value_grad`` (the
Pallas TPU kernel). Here the kernel is hand-written CUDA C++ for Hopper
(``csrc/fused_ls.cu``), built with nvcc for ``sm_90a`` at first use into
``adaprox_tpu_torch/_build/`` (keyed on the source's content hash), loaded
with ctypes and launched on the current stream.

``fused_ls_value_grad`` dispatches on where its tensors lie: CPU tensors take
the plain two-matmul version ``ls_value_grad_plain``; CUDA tensors launch the
kernel or raise. There is no fall-back from CUDA to the plain version.
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

__all__ = ["fused_ls_value_grad", "ls_value_grad_plain", "build_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_ls.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
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
    """Compile the CUDA source ``source`` (K1's by default) into a shared
    library with nvcc ``flags`` unless the build for this exact source and
    flag set exists already. Returns the path; nvcc's register/shared-memory
    report is kept beside it as ``.log``."""
    source = Path(source)
    src = source.read_bytes()
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


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.adaprox_fused_ls.argtypes = [p, i, i, p, p, ll, ll, i, p, p, p, p, p]
            lib.adaprox_fused_ls.restype = i
            lib.adaprox_fused_ls_rows_per_step.argtypes = [i]
            lib.adaprox_fused_ls_rows_per_step.restype = i
            lib.adaprox_cuda_error_string.argtypes = [i]
            lib.adaprox_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
