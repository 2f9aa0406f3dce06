"""The block-sparse (BCSR) data path, and K9a and K9b, its matvecs (counterpart of
``adaprox_tpu/ops/bcsr.py``).

Only the nonzero (bm, bn) tiles of A are stored (64 x 512 by default), and a matvec
streams exactly those: nnzb * bm * bn * itemsize bytes instead of the dense m * n *
itemsize. The format, built on the host by ``bcsr_from_dense``:

  * ``vals``   (nnzb, bm, bn): the nonzero tiles, block-row-major;
  * ``cols``   (nnzb,) int32: each tile's block column;
  * ``rowptr`` (nbr + 1,) int32: the block rows' extents, CSR style;
  * ``rows``   (nnzb,) int32: each tile's block row (``block_rows(rowptr)``);
  * ``colptr`` (nbc + 1,) and ``col_tiles`` (nnzb,) int32: the column index of the
    tile pattern (``block_cols(cols, nbc)``), each block column's tile ids in
    increasing order.

The JAX package takes A'y through a second BCSR structure built from A' at the same
tile shape (``vals_t`` ...), so both directions are gather-free streams on its TPU; the
"xla" route keeps that formulation. On the card the kernel routes take A'y from A's own
tiles (``bcsr_rmatvec``, ``bcsr_rmatvec_slab``): at the sparse case A' at A's tile
shape stores 5.6x A's bytes.

``bcsr_matvec`` (K9a) and ``bcsr_matvec_slab`` (K9b), A x, and ``bcsr_rmatvec`` and
``bcsr_rmatvec_slab``, their A'y, dispatch on where their tensors lie: CPU tensors take
the plain versions ``bcsr_matvec_plain`` (the counterpart of ``bcsr_matvec_xla``: gather
the x blocks, contract each tile, a segment sum over block rows) and
``bcsr_rmatvec_plain`` (the same over A's tiles transposed, a segment sum over block
columns); CUDA tensors launch the hand-written Hopper kernels (``csrc/bcsr_matvec.cu``,
built with nvcc for ``sm_90a`` at first use and loaded with ctypes) or raise. There is
no fall-back from CUDA to the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .linops import opnorm2, storage_norm, widened
from .sparse import _pad_up

__all__ = ["BCSROperator", "bcsr_from_dense", "bcsr_matvec", "bcsr_matvec_slab",
           "bcsr_matvec_plain", "bcsr_matvec_ref", "bcsr_rmatvec", "bcsr_rmatvec_slab",
           "bcsr_rmatvec_plain", "block_rows", "block_cols", "KERNELS", "build_library"]

SOURCE = kernels._PKG / "csrc" / "bcsr_matvec.cu"
# -fmad=false as every other source: the kernels' dot products use explicit fmaf
NVCC_FLAGS = kernels.NVCC_FLAGS + ("-fmad=false",)
# the default tile, 128 KB in f32 (the JAX package's, chosen on its TPU)
_BM = 64
_BN = 512
# BCSROperator's matvec routes: the library formulation, K9a, K9b
KERNELS = ("xla", "pallas", "slab")


def bcsr_from_dense(dense_np, bm=_BM, bn=_BN):
    """(vals, cols, rowptr, padded_shape) of the (bm, bn) blocking of a dense numpy
    matrix, zero-padded to whole tiles. A tile is stored iff it has a nonzero; an
    all-zero matrix keeps one zero tile (block row 0, column 0) so shapes are valid."""
    d = np.asarray(dense_np)
    m, n = d.shape
    mp, np_ = _pad_up(max(m, 1), bm), _pad_up(max(n, 1), bn)
    dp = np.zeros((mp, np_), d.dtype)
    dp[:m, :n] = d
    nbr, nbc = mp // bm, np_ // bn
    tiles = dp.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
    mask = (tiles != 0).any(axis=(2, 3))  # (nbr, nbc)
    vals, cols, rowptr = [], [], [0]
    for i in range(nbr):
        for c in np.nonzero(mask[i])[0]:
            vals.append(tiles[i, c])
            cols.append(c)
        rowptr.append(len(cols))
    if not vals:
        vals, cols, rowptr = [np.zeros((bm, bn), d.dtype)], [0], [0] + [1] * nbr
    return (np.stack(vals), np.asarray(cols, np.int32), np.asarray(rowptr, np.int32),
            (mp, np_))


def block_rows(rowptr):
    """Each tile's block row, (nnzb,) int32, from the extents ``rowptr`` (numpy)."""
    rowptr = np.asarray(rowptr)
    return np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr)).astype(np.int32)


def block_cols(cols, nbc):
    """(colptr (nbc + 1,), col_tiles (nnzb,)) int32, the column index of the tile pattern
    from each tile's block column ``cols`` (numpy): the tile ids of block column c are
    col_tiles[colptr[c] : colptr[c + 1]], in increasing order (a stable sort)."""
    c = np.asarray(cols, np.int64)
    colptr = np.concatenate([[0], np.cumsum(np.bincount(c, minlength=int(nbc)))])
    return colptr.astype(np.int32), np.argsort(c, kind="stable").astype(np.int32)


def bcsr_matvec_ref(vals, cols, rowptr, x):
    """The numpy reference, tile by tile (validation only)."""
    v, c, rp, xv = (np.asarray(a) for a in (vals, cols, rowptr, x))
    nbr = rp.shape[0] - 1
    bm, bn = v.shape[1], v.shape[2]
    y = np.zeros(nbr * bm, xv.dtype)
    for i in range(nbr):
        for f in range(rp[i], rp[i + 1]):
            y[i * bm:(i + 1) * bm] += v[f] @ xv[c[f] * bn:(c[f] + 1) * bn]
    return y


def bcsr_matvec_plain(vals, cols, rows, x, nbr, rowptr=None):
    """y = A x over the stored tiles (counterpart of ``bcsr_matvec_xla``): the x
    blocks gathered, each tile contracted with its block (a batched product), then a
    segment sum over the block rows, in ``x``'s dtype (bf16 ``vals`` upcast to it).
    ``rows`` (nnzb,) in any order; ``rowptr``, where ``rows`` is block-row-major,
    spares the sort. Deterministic on either device: each block row is summed in
    tile order by ``torch.segment_reduce`` (no atomics). Returns (nbr * bm,)."""
    bn = vals.shape[2]
    xblk = torch.index_select(x.reshape(-1, bn), 0, cols)  # (nnzb, bn)
    contrib = torch.bmm(vals.to(x.dtype), xblk.unsqueeze(2)).squeeze(2)  # (nnzb, bm)
    if rowptr is None:
        order = torch.argsort(rows, stable=True)
        lengths = torch.bincount(rows, minlength=int(nbr))
        y = torch.segment_reduce(contrib[order], "sum", lengths=lengths, axis=0, unsafe=True)
    else:
        y = torch.segment_reduce(contrib, "sum", offsets=rowptr, axis=0, unsafe=True)
    return y.reshape(-1)


def bcsr_rmatvec_plain(vals, rows, colptr, col_tiles, y, nbc):
    """x = A'y over A's stored tiles: the y blocks gathered by ``rows``, each tile's
    transpose contracted with its block (a batched product, (nnzb, bn) partials), then a
    segment sum over the block columns, each in ``col_tiles`` order (``colptr`` its
    extents), in ``y``'s dtype (bf16 ``vals`` upcast to it). Deterministic on either
    device (``torch.segment_reduce``, no atomics). Returns (nbc * bn,)."""
    bm, bn = vals.shape[1], vals.shape[2]
    yblk = torch.index_select(y.reshape(-1, bm), 0, rows)  # (nnzb, bm)
    contrib = torch.bmm(yblk.unsqueeze(1), vals.to(y.dtype)).squeeze(1)  # (nnzb, bn)
    x = torch.segment_reduce(torch.index_select(contrib, 0, col_tiles), "sum",
                             offsets=colptr, axis=0, unsafe=True)
    return x.reshape(int(nbc) * bn)


def build_library():
    """Compile ``csrc/bcsr_matvec.cu`` (see ``ops.kernels.build_library``)."""
    return kernels.build_library(SOURCE, NVCC_FLAGS)


def _library():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return kernels.load_library(SOURCE, NVCC_FLAGS, {
        "adaprox_bcsr_matvec": ([p, i, i, p, p, p, ll, i, i, p, p], i),
        "adaprox_bcsr_matvec_slab": ([p, i, i, p, p, ll, i, p, ll, i, i, p, p, p], i),
        "adaprox_bcsr_rmatvec": ([p, i, i, p, p, p, p, ll, i, i, p, p], i),
        "adaprox_bcsr_rmatvec_slab": ([p, i, i, p, p, p, ll, p, ll, i, i, p, p, p], i),
        "adaprox_bcsr_error_string": ([i], ctypes.c_char_p)})


def _check(name, vals, cols, index, x):
    """The checks both entries share; returns (nnzb, bm, bn)."""
    if vals.ndim != 3 or cols.ndim != 1 or index.ndim != 1 or x.ndim != 1:
        raise ValueError(f"{name}: need vals (nnzb, bm, bn), cols, rowptr/rows and x 1-d; "
                         f"got {tuple(vals.shape)}, {tuple(cols.shape)}, "
                         f"{tuple(index.shape)}, {tuple(x.shape)}")
    nnzb, bm, bn = vals.shape
    if cols.shape[0] != nnzb or nnzb < 1:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} for {nnzb} stored tiles")
    if x.shape[0] % bn or x.shape[0] < bn:
        raise ValueError(f"{name}: x of length {x.shape[0]} is not whole blocks of {bn}")
    if not (vals.device == cols.device == index.device == x.device):
        raise ValueError(f"{name}: vals, cols, rowptr/rows, x on different devices: "
                         f"{vals.device}, {cols.device}, {index.device}, {x.device}")
    if cols.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError(f"{name}: cols and rowptr/rows must be int32, got {cols.dtype}, "
                        f"{index.dtype}")
    return nnzb, bm, bn


def _check_t(name, vals, rows, colptr, col_tiles, nbc, y):
    """The checks both A'y entries share; returns (nnzb, bm, bn, nbc)."""
    if vals.ndim != 3 or rows.ndim != 1 or colptr.ndim != 1 or col_tiles.ndim != 1 or \
            y.ndim != 1:
        raise ValueError(f"{name}: need vals (nnzb, bm, bn), rows, colptr, col_tiles and y "
                         f"1-d; got {tuple(vals.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(colptr.shape)}, {tuple(col_tiles.shape)}, {tuple(y.shape)}")
    nnzb, bm, bn = vals.shape
    nbc = int(nbc)
    if nnzb < 1 or rows.shape[0] != nnzb or col_tiles.shape[0] != nnzb:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} and col_tiles "
                         f"{tuple(col_tiles.shape)} for {nnzb} stored tiles")
    if nbc < 1 or colptr.shape[0] != nbc + 1:
        raise ValueError(f"{name}: colptr {tuple(colptr.shape)} for {nbc} block columns")
    if y.shape[0] % bm or y.shape[0] < bm:
        raise ValueError(f"{name}: y of length {y.shape[0]} is not whole blocks of {bm}")
    if not (vals.device == rows.device == colptr.device == col_tiles.device == y.device):
        raise ValueError(f"{name}: vals, rows, colptr, col_tiles, y on different devices: "
                         f"{vals.device}, {rows.device}, {colptr.device}, "
                         f"{col_tiles.device}, {y.device}")
    if not all(t.dtype == torch.int32 for t in (rows, colptr, col_tiles)):
        raise TypeError(f"{name}: rows, colptr and col_tiles must be int32, got {rows.dtype}, "
                        f"{colptr.dtype}, {col_tiles.dtype}")
    return nnzb, bm, bn, nbc


def _check_cuda(name, vals, v, *ints, v_aligned=True):
    """The CUDA-only checks; returns (vals_is_bf16, vec). ``v_aligned``: the kernel reads
    ``v`` in vectors too (A x), so it must be 16-byte aligned for vec 4."""
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} stores vals as float32 or bfloat16 on CUDA, got {vals.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 {'x' if v_aligned else 'y'} on CUDA, got "
                        f"{v.dtype}")
    if not all(t.is_contiguous() for t in (vals, v, *ints)):
        raise ValueError(f"{name} needs contiguous vals, index arrays and vector")
    bn = vals.shape[2]
    aligned = vals.data_ptr() % 16 == 0 and (not v_aligned or v.data_ptr() % 16 == 0)
    return int(vals.dtype == torch.bfloat16), 4 if bn % 4 == 0 and aligned else 1


def _raise_on(lib, err, name):
    if err:
        msg = lib.adaprox_bcsr_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def bcsr_matvec(vals, cols, rowptr, max_bpr, x):
    """y = A x over the BCSR structure (counterpart of the JAX ``bcsr_matvec``, K9a):
    ``x`` (nbc * bn,), returns (nbr * bm,). ``max_bpr``, the largest tile count of a
    block row, is the JAX kernel's grid extent; it is taken as there (a positive int),
    but the kernel loops over exactly each block row's tiles.

    CPU tensors: the plain version, any float dtype, accumulated in ``x``'s. CUDA
    tensors: the K9a kernel; ``vals`` float32 or bfloat16, ``x`` float32, ``cols`` and
    ``rowptr`` int32, all contiguous; returns float32. Anything else raises. Each kernel
    launch adds one to ``bcsr_matvec.launches``."""
    _, bm, bn = _check("K9a", vals, cols, rowptr, x)
    if int(max_bpr) < 1:
        raise ValueError(f"K9a needs max_bpr >= 1, got {max_bpr}")
    nbr = rowptr.shape[0] - 1
    if nbr < 1:
        raise ValueError("K9a needs at least one block row")
    if vals.device.type == "cpu":
        rows = torch.repeat_interleave(torch.arange(nbr, dtype=torch.int32),
                                       torch.diff(rowptr))
        return bcsr_matvec_plain(vals, cols, rows, x, nbr, rowptr=rowptr)
    if vals.device.type != "cuda":
        raise ValueError(f"K9a runs on CPU (plain version) or CUDA tensors, not {vals.device}")
    bf16, vec = _check_cuda("K9a", vals, x, cols, rowptr)
    y = torch.empty(nbr * bm, dtype=torch.float32, device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.adaprox_bcsr_matvec(vals.data_ptr(), bf16, vec, cols.data_ptr(),
                                      rowptr.data_ptr(), x.data_ptr(), nbr, bm, bn,
                                      y.data_ptr(), stream)
    _raise_on(lib, err, "K9a")
    bcsr_matvec.launches += 1
    return y


bcsr_matvec.launches = 0


def bcsr_matvec_slab(vals, cols, rows, nbr, x, slab=8):
    """y = A x over BCSR storage, slab by slab (counterpart of the JAX
    ``bcsr_matvec_slab``, K9b): ``rows`` (nnzb,) each tile's block row, block-row-major;
    ``nbr`` the block rows; ``x`` (nbc * bn,); returns (nbr * bm,). The tile count is
    padded to a multiple of ``slab`` with zero tiles at block row 0, block column 0, as
    in JAX: they add 0 * x[0 : bn] to block row 0 (NaN where that block is not finite).

    CPU tensors: the plain version on the padded tiles, any float dtype. CUDA tensors:
    the K9b kernels (the padding is computed, not stored); ``vals`` float32 or
    bfloat16, 16-byte aligned and a multiple of 16 bytes in all (its first pass streams
    it by bulk copies), ``x`` float32, ``cols`` and ``rows`` int32, all contiguous,
    ``rows`` nondecreasing; returns float32. Anything else raises. Each launch (of its
    two passes) adds one to ``bcsr_matvec_slab.launches``."""
    nnzb, bm, bn = _check("K9b", vals, cols, rows, x)
    nbr, slab = int(nbr), int(slab)
    if nbr < 1 or slab < 1 or rows.shape[0] != nnzb:
        raise ValueError(f"K9b needs nbr >= 1, slab >= 1 and one row id a tile; got nbr {nbr}, "
                         f"slab {slab}, rows {tuple(rows.shape)}")
    pad = (-nnzb) % slab
    if vals.device.type == "cpu":
        if pad:
            vals = torch.cat([vals, vals.new_zeros((pad, bm, bn))])
            cols = torch.cat([cols, cols.new_zeros(pad)])
            rows = torch.cat([rows, rows.new_zeros(pad)])
        return bcsr_matvec_plain(vals, cols, rows, x, nbr)
    if vals.device.type != "cuda":
        raise ValueError(f"K9b runs on CPU (plain version) or CUDA tensors, not {vals.device}")
    bf16, vec = _check_cuda("K9b", vals, x, cols, rows)
    if vals.data_ptr() % 16 or (vals.numel() * vals.element_size()) % 16:
        raise ValueError("K9b streams vals by bulk copies: it needs vals 16-byte aligned "
                         f"and a multiple of 16 bytes, got {vals.numel()} values of "
                         f"{vals.element_size()} bytes at address {vals.data_ptr()}")
    part = torch.empty(nnzb * bm, dtype=torch.float32, device=vals.device)
    y = torch.empty(nbr * bm, dtype=torch.float32, device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.adaprox_bcsr_matvec_slab(vals.data_ptr(), bf16, vec, cols.data_ptr(),
                                           rows.data_ptr(), nnzb, slab, x.data_ptr(), nbr, bm,
                                           bn, part.data_ptr(), y.data_ptr(), stream)
    _raise_on(lib, err, "K9b")
    bcsr_matvec_slab.launches += 1
    return y


bcsr_matvec_slab.launches = 0


def _rmatvec(name, counted, vals, rows, colptr, col_tiles, nbc, y):
    """K9a's (``name`` "K9a") or K9b's A'y: the checks, the plain version on CPU tensors,
    the launch on CUDA ones, counted on ``counted.launches``."""
    nnzb, bm, bn, nbc = _check_t(name, vals, rows, colptr, col_tiles, nbc, y)
    if vals.device.type == "cpu":
        return bcsr_rmatvec_plain(vals, rows, colptr, col_tiles, y, nbc)
    if vals.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU (plain version) or CUDA tensors, not {vals.device}")
    bf16, vec = _check_cuda(name, vals, y, rows, colptr, col_tiles, v_aligned=False)
    x = torch.empty(nbc * bn, dtype=torch.float32, device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        ptrs = (vals.data_ptr(), bf16, vec, rows.data_ptr(), colptr.data_ptr(),
                col_tiles.data_ptr())
        if name == "K9a":
            err = lib.adaprox_bcsr_rmatvec(*ptrs, y.data_ptr(), nbc, bm, bn, x.data_ptr(),
                                           stream)
        else:
            part = torch.empty(nnzb * bn, dtype=torch.float32, device=vals.device)
            err = lib.adaprox_bcsr_rmatvec_slab(*ptrs, nnzb, y.data_ptr(), nbc, bm, bn,
                                                part.data_ptr(), x.data_ptr(), stream)
    _raise_on(lib, err, name)
    counted.launches += 1
    return x


def bcsr_rmatvec(vals, rows, colptr, col_tiles, nbc, y):
    """x = A'y over A's own stored tiles (K9a's A'y, one pass): ``rows`` (nnzb,) each
    tile's block row, ``colptr`` (nbc + 1,) and ``col_tiles`` (nnzb,) the column index
    (``block_cols``), ``y`` (nbr * bm,); returns (nbc * bn,), each output the sum of its
    block column's tile partials in ``col_tiles`` order. A non-finite y[r] reaches every
    output of each block column that has a tile in r's block row, and no other.

    CPU tensors: ``bcsr_rmatvec_plain``, any float dtype. CUDA tensors: the kernel;
    ``vals`` float32 or bfloat16, ``y`` float32, the index arrays int32, all contiguous;
    returns float32. Anything else raises. Each launch adds one to
    ``bcsr_matvec.launches``, K9a's count."""
    return _rmatvec("K9a", bcsr_matvec, vals, rows, colptr, col_tiles, nbc, y)


def bcsr_rmatvec_slab(vals, rows, colptr, col_tiles, nbc, y):
    """x = A'y over A's own stored tiles (K9b's A'y, two passes: each tile's partial,
    then each block column's sum in ``col_tiles`` order), the arguments and result as
    ``bcsr_rmatvec``'s and its bits on finite input. Over A's tiles there is no slab
    padding. Each launch (of its two passes) adds one to ``bcsr_matvec_slab.launches``,
    K9b's count."""
    return _rmatvec("K9b", bcsr_matvec_slab, vals, rows, colptr, col_tiles, nbc, y)


@dataclass(frozen=True)
class BCSROperator:
    """A linear operator over (bm, bn) block-sparse storage, both directions: A's
    structure (``vals``, ``cols``, ``rowptr``, ``rows``) with its column index
    (``colptr``, ``col_tiles``), A''s structure at the same tile shape (``*_t``), the
    true ``shape``, the zero-padded ``padded_shape``, each direction's largest tile count
    of a block row (``max_bpr``, ``max_bpr_t``) and the matvec route ``kernel``:

      * "xla" (the default): ``bcsr_matvec_plain`` both ways, A'y over A''s structure:
        the JAX package's library formulation (gather, batched product, segment sum) on
        either device, with the block rows' extents, deterministic on the card too;
      * "pallas": K9a, ``bcsr_matvec`` for A x and ``bcsr_rmatvec`` for A'y over A's own
        tiles, on CUDA tensors (their plain versions on CPU ones);
      * "slab": K9b, ``bcsr_matvec_slab`` with slabs of 8 tiles and
        ``bcsr_rmatvec_slab``.

    The kernel routes never read ``vals_t``. A CUDA tensor with "pallas" or "slab"
    launches its kernel or raises; it never takes "xla" instead. ``block_density``
    (stored tiles / all tiles at this granularity) is the ratio of the bytes a matvec
    reads to dense A's. Construct with ``from_dense``."""

    vals: torch.Tensor
    cols: torch.Tensor
    rowptr: torch.Tensor
    rows: torch.Tensor
    colptr: torch.Tensor
    col_tiles: torch.Tensor
    vals_t: torch.Tensor
    cols_t: torch.Tensor
    rowptr_t: torch.Tensor
    rows_t: torch.Tensor
    shape: tuple
    padded_shape: tuple
    max_bpr: int
    max_bpr_t: int
    kernel: str = "xla"

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got {self.kernel!r}")

    @classmethod
    def from_dense(cls, dense, block=(_BM, _BN), kernel="xla", *, device=None, dtype=None):
        """The operator of the dense matrix ``dense`` (a numpy array or a tensor) at tile
        shape ``block``, both structures built on the host and placed on ``device`` (the
        tensor's own, else "cuda") with ``vals`` in ``dtype`` (the matrix's own by
        default)."""
        if isinstance(dense, torch.Tensor):
            device = dense.device if device is None else device
            dense = dense.detach().cpu().numpy()
        d = np.asarray(dense)
        bm, bn = block
        vals, cols, rowptr, _ = bcsr_from_dense(d, bm, bn)
        vals_t, cols_t, rowptr_t, _ = bcsr_from_dense(d.T, bm, bn)
        return cls.from_arrays(vals, cols, rowptr, vals_t, cols_t, rowptr_t, d.shape,
                               kernel=kernel, device="cuda" if device is None else device,
                               dtype=dtype)

    @classmethod
    def from_arrays(cls, vals, cols, rowptr, vals_t, cols_t, rowptr_t, shape, *, kernel="xla",
                    device, dtype=None):
        """The operator of given BCSR arrays (numpy or tensors) of A and A' on ``device``:
        the index arrays as int32, ``vals`` in ``dtype`` (their own by default); the
        block rows, A's column index, padded shape and largest tile counts derived from
        them."""
        vals, vals_t = torch.as_tensor(np.array(vals)), torch.as_tensor(np.array(vals_t))
        dt = vals.dtype if dtype is None else dtype
        rowptr, rowptr_t = np.asarray(rowptr), np.asarray(rowptr_t)
        bm, bn = vals.shape[1], vals.shape[2]

        def idx(v):
            return torch.as_tensor(np.array(v, dtype=np.int32), device=device)

        m, n = (int(s) for s in shape)
        padded_n = _pad_up(max(n, 1), bn)
        colptr, col_tiles = block_cols(np.asarray(cols), padded_n // bn)
        return cls(vals=vals.to(device=device, dtype=dt).contiguous(), cols=idx(cols),
                   rowptr=idx(rowptr), rows=idx(block_rows(rowptr)), colptr=idx(colptr),
                   col_tiles=idx(col_tiles),
                   vals_t=vals_t.to(device=device, dtype=dt).contiguous(), cols_t=idx(cols_t),
                   rowptr_t=idx(rowptr_t), rows_t=idx(block_rows(rowptr_t)), shape=(m, n),
                   padded_shape=(_pad_up(max(m, 1), bm), padded_n),
                   max_bpr=int(np.diff(rowptr).max(initial=1)),
                   max_bpr_t=int(np.diff(rowptr_t).max(initial=1)), kernel=kernel)

    @property
    def block_density(self):
        bm, bn = self.vals.shape[1], self.vals.shape[2]
        nbr = self.padded_shape[0] // bm
        nbc = self.padded_shape[1] // bn
        return self.vals.shape[0] / max(1, nbr * nbc)

    @staticmethod
    def _padded(v, block):
        pad = _pad_up(v.shape[0], block) - v.shape[0]
        return F.pad(v, (0, pad)) if pad else v.contiguous()

    def _mv(self, vals, cols, rowptr, rows, max_bpr, v, out_dim):
        vp = self._padded(v, vals.shape[2])
        nbr = rowptr.shape[0] - 1
        if self.kernel == "pallas":
            y = bcsr_matvec(vals, cols, rowptr, max_bpr, vp)
        elif self.kernel == "slab":
            y = bcsr_matvec_slab(vals, cols, rows, nbr, vp)
        else:
            y = bcsr_matvec_plain(vals, cols, rows, vp, nbr, rowptr=rowptr)
        return y[:out_dim]

    def matvec(self, x):
        return self._mv(self.vals, self.cols, self.rowptr, self.rows, self.max_bpr, x,
                        self.shape[0])

    def rmatvec(self, y):
        if self.kernel == "xla":
            return self._mv(self.vals_t, self.cols_t, self.rowptr_t, self.rows_t,
                            self.max_bpr_t, y, self.shape[1])
        fn = bcsr_rmatvec if self.kernel == "pallas" else bcsr_rmatvec_slab
        x = fn(self.vals, self.rows, self.colptr, self.col_tiles, self.colptr.shape[0] - 1,
               self._padded(y, self.vals.shape[1]))
        return x[:self.shape[1]]

    def norm(self):
        """The Frobenius norm (Julia's ``norm(A)``; the stored tiles hold every nonzero),
        in the storage dtype as the JAX package computes it (bf16 vals: a bf16 norm)."""
        return storage_norm(self.vals)

    def opnorm(self, iters=100, key=None):
        return opnorm2(self, iters=iters, key=key, n=self.shape[1],
                       dtype=widened(self.vals.dtype), device=self.vals.device)
