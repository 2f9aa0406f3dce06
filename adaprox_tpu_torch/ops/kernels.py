"""The fused oracles: K1, least squares (f = 0.5 ||A x - b||^2 and
grad = A'(A x - b)), and K3, the mean logistic loss (f and its gradient in
the weights and the bias), each in one call; and the stream probes K10a
(``hbm_read_reduce``), K10b (``hbm_copy``) and K10c (``hbm_dma_read``),
which measure how fast the card reads and writes device memory.

Counterparts of ``adaprox_tpu/ops/kernels.py::fused_ls_value_grad``,
``fused_logistic_value_grad``, ``hbm_read_reduce``, ``hbm_copy`` and
``hbm_dma_read`` (Pallas TPU kernels). Here each kernel is hand-written CUDA
C++ for Hopper (``csrc/fused_ls.cu``, ``csrc/fused_logistic.cu``,
``csrc/hbm_stream.cu``), built with nvcc for ``sm_90a`` at first use into
``adaprox_tpu_torch/_build/`` (keyed on the source's content hash), loaded
with ctypes (one library handle a source) and launched on the current
stream.

Every wrapper dispatches on where its tensors lie: CPU tensors take the plain
version (``ls_value_grad_plain``, ``logistic_value_grad_plain``,
``hbm_read_reduce_plain``, ``hbm_copy_plain``, ``hbm_dma_read_plain``); CUDA
tensors launch the kernel or raise. There is no fall-back from CUDA to the
plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from .linops import acc_dtype

__all__ = ["fused_ls_value_grad", "ls_value_grad_plain", "fused_logistic_value_grad",
           "logistic_value_grad_plain", "logistic_terms", "pick_block_rows", "k1_plan",
           "hbm_read_reduce", "hbm_read_reduce_plain", "hbm_copy", "hbm_copy_plain",
           "hbm_dma_read", "hbm_dma_read_plain", "build_library", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_ls.cu"
LOGISTIC_SOURCE = _PKG / "csrc" / "fused_logistic.cu"
STREAM_SOURCE = _PKG / "csrc" / "hbm_stream.cu"
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


def _library(source=None):
    return load_library(source or SOURCE, NVCC_FLAGS, {
        "adaprox_fused_ls": ([_P, _I, _I, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _P], _I),
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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    """The SMs of CUDA device ``device_index`` (asked once a device)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _grid(m, rows_per_step, device):
    """One CTA per SM (the persistent grid), at most one per block of rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-m // rows_per_step), sms)


# K1's plan (csrc/fused_ls.cu). The partial slots, from the shape alone (so the bits depend on
# neither the card nor the grid): about as many as a 132-SM H100 runs CTAs at once, two an SM
# for the rows kernel, one an SM times the CTAs of the shape's width an SM for the ring kernel.
K1_ROW_SLOTS = 264
K1_RING_SLOTS = 132
K1_ROW_WARPS = 8          # warps of a rows-kernel CTA, each a row at a time
K1_ROW_MIN_SLOT = 16      # rows a slot at least: two rows a warp (rows kernel)
K1_RING_MIN_SLOT = 8      # rows a slot at least (ring kernel): a slot's partial is n floats
K1_NARROW_N = 1024        # widest rows the rows kernel takes: 32 values a lane
K1_RING_COLS = 16         # columns of x and of the gradient a ring-kernel thread holds
K1_MAX_THREADS = 1024
K1_MAX_CLUSTER = 8
K1_MAX_STAGES = 8
K1_SM_SMEM = 233472       # shared memory an SM (228 KB)
K1_CTA_SMEM = 232448      # the most a CTA may take (227 KB, opt-in)
K1_CTA_RESERVED = 1024    # what the card keeps of an SM's shared memory for each CTA
K1_RING_STATIC = 512      # the ring kernel's own static shared memory, rounded up
K1_PLAN_KEYS = ("regime", "k", "threads", "grid", "cluster", "slice_vec", "stages", "stride",
                "smem", "rows_per_slot", "slots")


def k1_plan(m, n, itemsize, sms):
    """K1's launch at (m, n) with A's ``itemsize`` (4: f32, 2: bf16) on a card of ``sms``
    SMs: a dict of ``K1_PLAN_KEYS``. The slots (``rows_per_slot``, ``slots``) and the
    arithmetic (``regime``, ``k``, ``threads``, ``cluster``, ``slice_vec``) follow from
    (m, n, itemsize) alone; ``sms`` sets only the grid (and, through the CTAs an SM, the
    ring's depth), so the bits do not depend on it.

    * ``"rows"`` (n <= K1_NARROW_N): a warp a row, ``k`` values of it a lane (8, 16 or
      32), 8 warps a CTA; ``smem`` is the CTA's static shared memory.
    * ``"ring"``: a CTA of ``threads`` takes its ``slice_vec`` 16-byte vectors of a row at a
      time from a ring of ``stages`` slots of ``stride`` bytes (``smem`` in all) fed by bulk
      copies; a row wider than one CTA's 16384 columns is cut over a cluster of ``cluster``
      CTAs. Raises ValueError past K1_MAX_CLUSTER x 16384 columns. ``stages`` does not
      change the arithmetic either: each row's dot and update are the same, in the same
      order."""
    if itemsize not in (2, 4):
        raise ValueError(f"K1 stores A as float32 or bfloat16, got itemsize {itemsize}")
    if m < 1 or n < 1 or sms < 1:
        raise ValueError(f"K1 needs m, n, sms >= 1, got {m}, {n}, {sms}")
    lanes = 16 // itemsize
    nvec = -(-n // lanes)
    if n <= K1_NARROW_N:
        k = next(k for k in (8, 16, 32) if k >= lanes and 32 * k >= nvec * lanes)
        rows_per_slot = max(K1_ROW_MIN_SLOT, -(-m // K1_ROW_SLOTS))
        slots = -(-m // rows_per_slot)
        return dict(regime="rows", k=k, threads=32 * K1_ROW_WARPS, grid=min(slots, 2 * sms),
                    cluster=1, slice_vec=nvec, stages=0, stride=0,
                    smem=4 * (32 * k * (1 + K1_ROW_WARPS) + K1_ROW_WARPS),
                    rows_per_slot=rows_per_slot, slots=slots)
    per_thread = K1_RING_COLS // lanes  # vectors a thread holds
    cluster = next((c for c in (1, 2, 4, 8) if -(-nvec // c) <= K1_MAX_THREADS * per_thread),
                   None)
    if cluster is None:
        raise ValueError(f"K1 holds a row's gradient slice on chip: at most "
                         f"{K1_MAX_CLUSTER * K1_MAX_THREADS * K1_RING_COLS} columns on CUDA, "
                         f"got n={n}")
    slice_vec = -(-nvec // cluster)
    threads = 32 * -(-slice_vec // (32 * per_thread))
    per_sm = max(1, min(8, K1_MAX_THREADS // threads))  # 64 registers a thread at most
    stride = 16 * slice_vec + 16  # a slice, and the offset of a row that is not 16-byte aligned
    budget = min(K1_CTA_SMEM, K1_SM_SMEM // per_sm - K1_CTA_RESERVED) - K1_RING_STATIC
    stages = min(K1_MAX_STAGES, budget // stride)
    rows_per_slot = max(K1_RING_MIN_SLOT, -(-m // (K1_RING_SLOTS * per_sm)))
    slots = -(-m // rows_per_slot)
    clusters = min(slots, max(1, sms * per_sm // cluster))
    return dict(regime="ring", k=K1_RING_COLS, threads=threads, grid=clusters * cluster,
                cluster=cluster, slice_vec=slice_vec, stages=stages, stride=stride,
                smem=stages * stride, rows_per_slot=rows_per_slot, slots=slots)


def _k1_numbers(plan):
    """``plan`` as the C entry takes it: its K1_PLAN_KEYS in order (regime 0 rows, 1 ring)."""
    numbers = [int(plan[key]) if key != "regime" else int(plan[key] == "ring")
               for key in K1_PLAN_KEYS]
    return (ctypes.c_longlong * len(numbers))(*numbers)


@functools.lru_cache(maxsize=256)
def _k1_cached_plan(m, n, itemsize, device_index):
    """(plan, its numbers) of a shape on a device, made once: the wrapper's host time is on the
    engine's critical path at the lasso driver's sizes."""
    plan = k1_plan(m, n, itemsize, _sm_count(device_index))
    return plan, _k1_numbers(plan)


def _k1_launch(a, b, x, plan, numbers=None, lib=None):
    """One K1 launch on checked CUDA tensors with ``plan`` (``k1_plan``'s dict), from ``lib``
    (default: the build of SOURCE); adds one to ``fused_ls_value_grad.launches``."""
    lib = lib or _library()
    m, n = a.shape
    bf16 = a.dtype == torch.bfloat16
    vec = int(n % (16 // a.element_size()) == 0 and a.data_ptr() % 16 == 0)
    f32 = dict(dtype=torch.float32, device=a.device)
    f_part = torch.empty(plan["slots"], **f32)
    g_part = torch.empty((plan["slots"], n), **f32)
    f, grad = torch.empty((), **f32), torch.empty(n, **f32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.adaprox_fused_ls(
            a.data_ptr(), int(bf16), vec, b.data_ptr(), x.data_ptr(), m, n,
            numbers if numbers is not None else _k1_numbers(plan), f_part.data_ptr(),
            g_part.data_ptr(), f.data_ptr(), grad.data_ptr(), stream)
    if err:
        msg = lib.adaprox_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    fused_ls_value_grad.launches += 1
    return f, grad


def fused_ls_value_grad(a, b, x):
    """(f, grad) of 0.5 ||A x - b||^2. ``a`` (m, n), ``b`` (m,), ``x`` (n,).

    CPU tensors: the plain version, any float dtype. CUDA tensors: the K1
    kernel (``k1_plan``'s launch); ``a`` f32 or bf16, ``b`` and ``x`` f32, all
    contiguous, any m >= 1 and 1 <= n <= 131072; returns a 0-d f32 ``f`` and an
    (n,) f32 ``grad``. Anything else raises. Each kernel launch adds one to
    ``fused_ls_value_grad.launches``."""
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
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    return _k1_launch(a, b, x, *_k1_cached_plan(m, n, a.element_size(), index))


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


# -- K10a-c, the stream probes ---------------------------------------------------------

_SUBLANE = 8
_VMEM_TILE_BUDGET = 4 * 1024 * 1024


def pick_block_rows(m: int, n: int, itemsize: int) -> int:
    """The JAX package's row tile for ``hbm_read_reduce`` (a copy of
    ``adaprox_tpu/ops/kernels.py::pick_block_rows``): the largest multiple of
    8 rows (16 for 2-byte types), at most 1024, whose (rows, n) tile fits 4
    MiB and divides m, else the smallest such quantum. The port validates a
    ``block_rows`` with it as JAX does; the CUDA grid does not depend on it."""
    q = _SUBLANE * (2 if itemsize == 2 else 1)
    tm = max(q, min(1024, _VMEM_TILE_BUDGET // max(1, n * itemsize)))
    tm = (tm // q) * q
    while tm > q and m % tm:
        tm -= q
    return tm


def _stream_library():
    return load_library(STREAM_SOURCE, NVCC_FLAGS, {
        "adaprox_hbm_max_grid": ([], _I),
        "adaprox_hbm_read_reduce": ([_P, _I, _LL, _I, ctypes.c_float, _P, _LL, _P, _P], _I),
        "adaprox_hbm_copy": ([_P, _P, _I, _LL, _I, ctypes.c_float, _P], _I),
        "adaprox_hbm_dma_piece": ([_LL, _I, _I], _LL),
        "adaprox_hbm_dma_read": ([_P, _I, _LL, _LL, _I, _I, ctypes.c_float, _P, _LL, _P, _P],
                                 _I),
        "adaprox_hbm_error_string": ([_I], ctypes.c_char_p)})


def _stream_check(a, repeats, what):
    """(m, n) of a probe's array, after the checks both devices share."""
    if a.ndim != 2:
        raise ValueError(f"{what} takes an (m, n) array, got shape {tuple(a.shape)}")
    if not a.dtype.is_floating_point:
        raise TypeError(f"{what} takes a float array, got {a.dtype}")
    if int(repeats) != repeats or repeats < 1:
        raise ValueError(f"{what} needs repeats >= 1, got {repeats}")
    return a.shape


def _stream_cuda(a, what):
    """The library, after the checks of a CUDA launch; raises on anything else."""
    if a.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU (plain version) or CUDA tensors, not {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} reads float32 or bfloat16 on CUDA, got {a.dtype}")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned array on CUDA")
    if a.numel() < 1:
        raise ValueError(f"{what} needs a non-empty array, got {tuple(a.shape)}")
    return _stream_library()


def _stream_raise(lib, err, what):
    if err:
        msg = lib.adaprox_hbm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def hbm_read_reduce_plain(a, scale=1.0, block_rows=None, repeats=1):
    """The plain version of K10a: ``repeats`` passes of the column sums of
    ``a`` in f32, each times ``scale`` into an f32 (n,) accumulator, then
    its sum (JAX's accumulator; one pass is one column sum of the whole
    array). ``block_rows`` is validated only."""
    del block_rows
    s = torch.tensor(scale, dtype=torch.float32, device=a.device)
    acc = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for _ in range(repeats):
        acc += s * torch.sum(a, 0, dtype=torch.float32)
    return torch.sum(acc)


def hbm_read_reduce(a, scale=1.0, block_rows=None, repeats=1):
    """repeats * scale * sum(a) in f32, as ``repeats`` full read passes over
    ``a`` inside one launch: the read-stream probe (K10a). Time it over an
    array past the L2 (bench's 16384^2 f32, 1 GiB) to read the card's
    attainable read rate; divide by ``repeats``.

    ``block_rows`` (default ``pick_block_rows``) must divide m, as in the JAX
    package, where it is the row tile; it does not shape the CUDA grid.
    Returns a 0-d f32 tensor. CPU tensors: the plain version, any float
    dtype. CUDA tensors: K10a on a contiguous, 16-byte aligned f32 or bf16
    array; each launch adds one to ``hbm_read_reduce.launches``."""
    m, n = _stream_check(a, repeats, "hbm_read_reduce")
    tm = block_rows or pick_block_rows(m, n, a.element_size())
    if m % tm:
        raise ValueError(f"block_rows={tm} does not divide m={m}: the skipped tail would "
                         "silently inflate the measured bandwidth")
    if a.device.type == "cpu":
        return hbm_read_reduce_plain(a, scale, tm, repeats)
    lib = _stream_cuda(a, "hbm_read_reduce")
    f32 = dict(dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        part = torch.empty(lib.adaprox_hbm_max_grid(), dtype=torch.float64, device=a.device)
        out = torch.empty((), **f32)
        err = lib.adaprox_hbm_read_reduce(
            a.data_ptr(), int(a.dtype == torch.bfloat16), a.numel(), int(repeats), float(scale),
            part.data_ptr(), part.numel(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    _stream_raise(lib, err, "K10a")
    hbm_read_reduce.launches += 1
    return out


hbm_read_reduce.launches = 0


def _copy_token(out):
    """JAX's token of the copy: the first block's first 128 values and the
    last block's last 128, summed in f32."""
    return (torch.sum(out[0, :128].to(torch.float32))
            + torch.sum(out[-1, -128:].to(torch.float32)))


def hbm_copy_plain(a, scale=1.0, block_rows=128, repeats=1, out=None):
    """The plain version of K10b: ``repeats`` times out = a * scale, with
    scale rounded to f32 and then to a's dtype, as JAX casts it. Returns
    JAX's token; ``out`` (optional) receives the copy."""
    del block_rows
    s = torch.tensor(scale, dtype=torch.float32, device=a.device).to(a.dtype)
    out = torch.empty_like(a) if out is None else out
    for _ in range(repeats):
        torch.mul(a, s, out=out)
    return _copy_token(out)


def hbm_copy(a, scale=1.0, block_rows=128, repeats=1, out=None):
    """``repeats`` scaled copies out = a * scale (scale cast to a's dtype
    first) in one launch: the read+write stream probe (K10b), two passes over
    device memory a repeat. ``block_rows`` must divide m, as in the JAX
    package. Returns JAX's token, the f32 sum of out[0, :128] and
    out[-1, -128:], which samples both ends of the copy; ``out`` (optional,
    a's shape and dtype) receives the copy, which is otherwise allocated.

    CPU tensors: the plain version. CUDA tensors: K10b on a contiguous,
    16-byte aligned f32 or bf16 array; each launch adds one to
    ``hbm_copy.launches``."""
    m, _ = _stream_check(a, repeats, "hbm_copy")
    if m % block_rows:
        raise ValueError(f"block_rows={block_rows} does not divide m={m}")
    if out is not None and (out.shape != a.shape or out.dtype != a.dtype
                            or out.device != a.device or not out.is_contiguous()):
        raise ValueError("hbm_copy's out must be a contiguous array of a's shape, dtype and "
                         "device")
    if a.device.type == "cpu":
        return hbm_copy_plain(a, scale, block_rows, repeats, out)
    lib = _stream_cuda(a, "hbm_copy")
    out = torch.empty_like(a) if out is None else out
    if out.data_ptr() % 16:
        raise ValueError("hbm_copy needs a 16-byte aligned out on CUDA")
    with torch.cuda.device(a.device):
        err = lib.adaprox_hbm_copy(a.data_ptr(), out.data_ptr(), int(a.dtype == torch.bfloat16),
                                   a.numel(), int(repeats), float(scale),
                                   torch.cuda.current_stream(a.device).cuda_stream)
    _stream_raise(lib, err, "K10b")
    hbm_copy.launches += 1
    return _copy_token(out)


hbm_copy.launches = 0


def _dma_check(a, chunk_rows, depth, repeats):
    """(chunks, the clamped depth) of a DMA probe, after JAX's checks."""
    m, n = _stream_check(a, repeats, "hbm_dma_read")
    if m % chunk_rows:
        raise ValueError(f"chunk_rows={chunk_rows} does not divide m={m}")
    if n < 128:
        raise ValueError(f"hbm_dma_read's token reads columns 0:128; n={n} is narrower")
    if depth < 1:
        raise ValueError(f"hbm_dma_read needs depth >= 1, got {depth}")
    chunks = m // chunk_rows
    # a deeper pipeline than there are chunks would start copies the loop never
    # waits on (copies in flight at exit)
    return chunks, min(depth, chunks * repeats)


def hbm_dma_read_plain(a, scale=1.0, chunk_rows=128, depth=3, repeats=1):
    """The plain version of K10c's token: a (128,) f32 accumulator that
    starts at scale and adds row 0, columns 0:128, of every chunk of every
    pass, in pass order; then its sum. Reads only those rows."""
    chunks, _ = _dma_check(a, chunk_rows, depth, repeats)
    rows = a[::chunk_rows, :128].to(torch.float32)
    acc = torch.full((128,), float(scale), dtype=torch.float32, device=a.device)
    for _ in range(repeats):
        for i in range(chunks):
            acc += rows[i]
    return torch.sum(acc)


def hbm_dma_read(a, scale=1.0, chunk_rows=128, depth=3, repeats=1):
    """``repeats`` full passes over ``a`` as a ``depth``-deep pipeline of
    asynchronous bulk copies (TMA) into shared memory, with almost no compute
    (K10c): the ceiling probe, whether anything reads faster than K10a.
    ``chunk_rows`` must divide m; depth is clamped to chunks * repeats, as in
    the JAX package. Returns the token, the f32 sum of a (128,) accumulator
    that starts at scale and adds row 0, columns 0:128, of every chunk read.

    On the card each chunk is cut into pieces that fit shared memory, dealt
    to one CTA an SM, each with ``depth`` copies in flight. CPU tensors: the
    plain version. CUDA tensors: K10c on a contiguous, 16-byte aligned f32 or
    bf16 array whose chunks are whole 16-byte units; each launch adds one to
    ``hbm_dma_read.launches``."""
    chunks, depth = _dma_check(a, chunk_rows, depth, repeats)
    if a.device.type == "cpu":
        return hbm_dma_read_plain(a, scale, chunk_rows, depth, repeats)
    lib = _stream_cuda(a, "hbm_dma_read")
    chunk_bytes = chunk_rows * a.shape[1] * a.element_size()
    if chunk_bytes % 16:
        raise ValueError(f"hbm_dma_read copies whole 16-byte units on CUDA; a chunk of "
                         f"{chunk_bytes} bytes is not")
    if lib.adaprox_hbm_dma_piece(chunk_bytes, depth, a.element_size()) == 0:
        raise ValueError(f"depth={depth} leaves no room for a token row in shared memory")
    f32 = dict(dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        part = torch.empty(128 * lib.adaprox_hbm_max_grid(), **f32)
        out = torch.empty((), **f32)
        err = lib.adaprox_hbm_dma_read(
            a.data_ptr(), int(a.dtype == torch.bfloat16), chunks, chunk_bytes, depth,
            int(repeats), float(scale), part.data_ptr(), part.numel(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    _stream_raise(lib, err, "K10c")
    hbm_dma_read.launches += 1
    return out


hbm_dma_read.launches = 0
