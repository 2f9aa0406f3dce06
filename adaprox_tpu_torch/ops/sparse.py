"""The sparse data path in the padded-row (ELL) layout, and K8, its gather matvec
(counterpart of ``adaprox_tpu/ops/sparse.py``).

The reference stores LIBSVM data sparse (experiments/libsvm.jl:34,
SparseMatrixCSC) and its matvecs go through Julia's generic sparse BLAS. Here, as
in the JAX package:

  * the ELL layout: ``vals``/``cols`` of shape (m, k), k the largest row count of
    nonzeros rounded up to a multiple of 128 (at least 128), m padded to 8;
    padding entries are val 0 and col 0;
  * ``A x = sum(vals * x[cols], axis=1)``, a row-parallel gather;
  * ``A'y`` through a second ELL structure built from A' (the same layout), so
    both directions are gathers and nothing scatters.

``ell_matvec`` dispatches on where its tensors lie: CPU tensors take the plain
version ``ell_matvec_plain`` (the counterpart of ``ell_matvec_xla``); CUDA tensors
launch K8, the hand-written Hopper kernel (``csrc/ell_matvec.cu``, built with nvcc
for ``sm_90a`` at first use and loaded with ctypes), or raise. There is no
fall-back from CUDA to the plain version.

K8 reads only the entries a row holds: ``ELLOperator`` keeps each row's extent
(``held_lengths``: one past its last entry that is not (val 0, col 0)), and the
kernel stops there and adds the skipped padding's 0 * x[0] once, so that it computes
the padded sum, NaN from a non-finite x[0] included, from about a third of the bytes
at the sparse case.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels
from .linops import opnorm2, storage_norm, widened

__all__ = ["ELLOperator", "ell_from_dense_arrays", "ell_matvec", "ell_matvec_plain",
           "held_lengths", "build_library"]

SOURCE = kernels._PKG / "csrc" / "ell_matvec.cu"
# -fmad=false as every other source: the kernel's dot products use explicit fmaf
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
_LANE = 128
_SUBLANE = 8
_VEC = 4  # K8's vector width: the row extents are rounded up to it


def _pad_up(v, mult):
    return ((v + mult - 1) // mult) * mult


def _ell_arrays(dense_np, pad_rows_to=_SUBLANE, pad_k_to=_LANE):
    """(vals, cols, m_pad, k) padded-row arrays of a dense numpy matrix. Padding
    entries have val 0 and col 0."""
    m, n = dense_np.shape
    nnz_per_row = (dense_np != 0).sum(axis=1)
    k = int(nnz_per_row.max()) if m else 0
    k = max(_pad_up(max(k, 1), pad_k_to), pad_k_to)
    mp = _pad_up(max(m, 1), pad_rows_to)
    vals = np.zeros((mp, k), dense_np.dtype)
    cols = np.zeros((mp, k), np.int32)
    for i in range(m):
        idx = np.nonzero(dense_np[i])[0]
        vals[i, : idx.size] = dense_np[i, idx]
        cols[i, : idx.size] = idx
    return vals, cols, mp, k


def ell_from_dense_arrays(dense):
    """Both ELL structures, (vals, cols) of A and (vals_t, rows_t) of A', from a
    dense matrix (numpy arrays, equal to the JAX package's array for array)."""
    d = np.asarray(dense)
    vals, cols, _, _ = _ell_arrays(d)
    vals_t, rows_t, _, _ = _ell_arrays(np.ascontiguousarray(d.T))
    return vals, cols, vals_t, rows_t


def held_lengths(vals, cols):
    """(m,) int32 CPU tensor: the entries K8 reads of each row of the ELL arrays ``vals``,
    ``cols`` (CPU tensors): one past the row's last entry that is not (val 0, col 0), 0
    for a row of padding only, rounded up to K8's vector width (4) and capped at k. An
    interior (0, 0) entry is read; only the tail after the last held entry is skipped."""
    held = ((vals != 0) | (cols != 0)).numpy()
    m, k = held.shape
    if k == 0:
        return torch.zeros(m, dtype=torch.int32)
    last = np.where(held.any(axis=1), k - np.argmax(held[:, ::-1], axis=1), 0)
    return torch.from_numpy(np.minimum(_pad_up(last, _VEC), k).astype(np.int32))


def ell_matvec_plain(vals, cols, x, out_rows):
    """sum(vals * x[cols], axis=1)[:out_rows], accumulated in ``x``'s dtype (bf16
    ``vals`` are upcast to it): the counterpart of ``ell_matvec_xla``."""
    gathered = torch.index_select(x, 0, cols.reshape(-1)).reshape(cols.shape)
    return torch.sum(vals.to(x.dtype) * gathered, dim=1)[:out_rows]


def build_library():
    """Compile ``csrc/ell_matvec.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_ell_matvec": ([p, i, i, p, p, p, ll, ll, p, p], i),
        "adaprox_ell_error_string": ([i], ctypes.c_char_p)})


def ell_matvec(vals, cols, x, lengths=None):
    """y = sum(vals * x[cols], axis=1), all m rows (counterpart of
    ``ell_matvec_pallas``). ``vals`` and ``cols`` (m, k), ``cols`` int32 indices
    into ``x`` (n,); m must be a multiple of 8, as the JAX kernel requires.
    ``lengths`` (m,) int32, on the same device, contiguous: the entries each row
    holds (``held_lengths``; every entry past them must be (val 0, col 0)); None
    means k for every row.

    CPU tensors: the plain version over the whole padded rows, any float dtype,
    accumulated in ``x``'s. CUDA tensors: the K8 kernel, which reads row i's first
    lengths[i] entries only and adds 0 * x[0] once where lengths[i] < k (the padded
    sum, NaN from a non-finite x[0] included); ``vals`` float32 or bfloat16, ``x``
    float32, ``cols`` int32, all contiguous, every index in [0, n); returns an (m,)
    float32 ``y``. Anything else raises. Each kernel launch adds one to
    ``ell_matvec.launches``."""
    if vals.ndim != 2 or cols.shape != vals.shape or x.ndim != 1:
        raise ValueError(f"need vals (m, k), cols (m, k), x (n,); got {tuple(vals.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(x.shape)}")
    m, k = vals.shape
    if m % _SUBLANE:
        raise ValueError(f"ell_matvec needs m % {_SUBLANE} == 0, got m={m}; pad the row count "
                         "(ell_from_dense_arrays does)")
    if not (vals.device == cols.device == x.device):
        raise ValueError(f"vals, cols, x on different devices: {vals.device}, {cols.device}, "
                         f"{x.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if lengths is not None and (lengths.dtype != torch.int32 or lengths.shape != (m,)
                                or lengths.device != vals.device
                                or not lengths.is_contiguous()):
        if lengths.dtype != torch.int32:
            raise TypeError(f"lengths must be int32, got {lengths.dtype}")
        raise ValueError(f"lengths must be ({m},), on {vals.device} and contiguous; got "
                         f"{tuple(lengths.shape)} on {lengths.device}, contiguous "
                         f"{lengths.is_contiguous()}")
    if vals.device.type == "cpu":
        return ell_matvec_plain(vals, cols, x, m)
    if vals.device.type != "cuda":
        raise ValueError(f"K8 runs on CPU (plain version) or CUDA tensors, not {vals.device}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K8 stores vals as float32 or bfloat16 on CUDA, got {vals.dtype}")
    if x.dtype != torch.float32:
        raise TypeError(f"K8 takes a float32 x on CUDA, got {x.dtype}")
    if not (vals.is_contiguous() and cols.is_contiguous() and x.is_contiguous()):
        raise ValueError("K8 needs contiguous vals, cols and x")
    if x.shape[0] < 1 or k < 1:
        raise ValueError(f"K8 needs n, k >= 1, got n={x.shape[0]}, k={k}")
    y = torch.empty(m, dtype=torch.float32, device=vals.device)
    if m == 0:
        return y
    lib = _library()
    bf16 = vals.dtype == torch.bfloat16
    # 16-byte loads of cols (and of f32 vals; 8 bytes of bf16) need k % 4 and aligned rows
    vec = 4 if k % 4 == 0 and vals.data_ptr() % 16 == 0 and cols.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.adaprox_ell_matvec(vals.data_ptr(), int(bf16), vec, cols.data_ptr(),
                                     x.data_ptr(), None if lengths is None else lengths.data_ptr(),
                                     m, k, y.data_ptr(), stream)
    if err:
        msg = lib.adaprox_ell_error_string(err).decode()
        raise RuntimeError(f"K8 launch failed: CUDA error {err} ({msg})")
    ell_matvec.launches += 1
    return y


ell_matvec.launches = 0


@dataclass(frozen=True)
class ELLOperator:
    """A linear operator over the padded-row sparse format, both layouts:
    ``vals``/``cols`` (m_pad, k) of A and ``vals_t``/``rows_t`` (n_pad, kt) of A',
    ``shape`` the true (m, n); ``row_len`` (m_pad,) and ``row_len_t`` (n_pad,) int32,
    the entries each row of either layout holds (``held_lengths``, derived in
    ``from_arrays``).

    Both directions go through ``ell_matvec`` with their row extents: the plain gather
    over the padded rows on CPU tensors, K8 on CUDA tensors. The JAX package's operator
    takes the XLA gather on every backend, because Mosaic's lane gather takes
    single-vreg sources only (``adaprox_tpu/ops/sparse.py``); the card has no such
    limit, so here the kernel is the operator's path. Construct with ``from_dense``."""

    vals: torch.Tensor
    cols: torch.Tensor
    vals_t: torch.Tensor
    rows_t: torch.Tensor
    shape: tuple
    row_len: torch.Tensor
    row_len_t: torch.Tensor

    @classmethod
    def from_dense(cls, dense, *, device=None, dtype=None):
        """The operator of the dense matrix ``dense`` (a numpy array or a tensor), its
        structures built on the host and placed on ``device`` (the tensor's own, else
        "cuda") with ``vals`` in ``dtype`` (the matrix's own by default)."""
        if isinstance(dense, torch.Tensor):
            device = dense.device if device is None else device
            dense = dense.detach().cpu().numpy()
        d = np.asarray(dense)
        vals, cols, vals_t, rows_t = ell_from_dense_arrays(d)
        return cls.from_arrays(vals, cols, vals_t, rows_t, d.shape,
                               device="cuda" if device is None else device, dtype=dtype)

    @classmethod
    def from_arrays(cls, vals, cols, vals_t, rows_t, shape, *, device, dtype=None):
        """The operator of given ELL arrays (numpy or tensors) on ``device``; the index
        arrays as int32, ``vals`` in ``dtype`` (their own by default); the row extents
        counted on the host from the stored values."""
        vals, cols, vals_t, rows_t = (torch.as_tensor(np.array(v))
                                      for v in (vals, cols, vals_t, rows_t))
        dt = vals.dtype if dtype is None else dtype
        vals, vals_t = vals.to(dt), vals_t.to(dt)
        cols, rows_t = cols.to(torch.int32), rows_t.to(torch.int32)

        def put(v):
            return v.to(device=device).contiguous()

        return cls(vals=put(vals), cols=put(cols), vals_t=put(vals_t), rows_t=put(rows_t),
                   shape=tuple(int(s) for s in shape),
                   row_len=put(held_lengths(vals, cols)),
                   row_len_t=put(held_lengths(vals_t, rows_t)))

    @property
    def density(self):
        """Padded density k/n: the sparse path reads fewer bytes than dense below 1/2."""
        return self.vals.shape[1] / self.shape[1]

    def matvec(self, x):
        return ell_matvec(self.vals, self.cols, x, self.row_len)[: self.shape[0]]

    def rmatvec(self, y):
        return ell_matvec(self.vals_t, self.rows_t, y, self.row_len_t)[: self.shape[1]]

    def norm(self):
        """The Frobenius norm (Julia's ``norm(A)``; padding vals are 0), in the
        storage dtype as the JAX package computes it (bf16 vals: a bf16 norm)."""
        return storage_norm(self.vals)

    def opnorm(self, iters=100, key=None):
        return opnorm2(self, iters=iters, key=key, n=self.shape[1],
                       dtype=widened(self.vals.dtype), device=self.vals.device)
