"""The sparse data path of the port (``ops/sparse.py``: the ELL structure, K8's plain
version and ``ELLOperator``; ``ops/bcsr.py``: the BCSR structure, K9a's and K9b's plain
versions and ``BCSROperator``; ``ops/linops.opnorm2``; the oracles over an operator;
``convert.ell_from_numpy`` and ``bcsr_from_numpy``) against the JAX package's on the CPU,
in float64 unless a test says otherwise. The JAX side runs as ``tests/test_sparse.py``
and ``tests/test_bcsr.py`` run it: its kernels in interpret mode, its operators on their
XLA routes. Inputs come from a numpy seed and reach both sides as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_of

import adaprox_tpu as ap
import adaprox_tpu_torch as apt
from adaprox_tpu.models.objectives import LeastSquares as JLS
from adaprox_tpu.models.objectives import LogisticLoss as JLogistic
from adaprox_tpu.ops import bcsr as jb
from adaprox_tpu.ops import sparse as js
from adaprox_tpu.utils.datasets import synthetic_classification
from adaprox_tpu_torch.ops import bcsr as tb
from adaprox_tpu_torch.ops import sparse as ts
from adaprox_tpu_torch.utils.jax_random import normal

CPU = "cpu"


def t64(v):
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def _sparse_dense(m, n, density, seed):
    """test_sparse.py's matrix: Gaussian entries at the given density, one more entry a
    row so that no row is empty."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    d[np.arange(m), rng.integers(0, n, m)] += 1.0
    return d


def _block_sparse(m, n, density, seed, bm=8, bn=128):
    """test_bcsr.py's matrix: nonzeros in randomly chosen (bm, bn) tiles."""
    rng = np.random.default_rng(seed)
    mp, npd = -(-m // bm) * bm, -(-n // bn) * bn
    mask = rng.random((mp // bm, npd // bn)) < density
    d = rng.standard_normal((mp, npd)) * np.kron(mask, np.ones((bm, bn)))
    return d[:m, :n]


def _uneven(seed):
    """Rows of very different lengths, an empty row and an empty block row (8..15),
    a trailing empty block row (40..47 of 48)."""
    d = _block_sparse(48, 640, 0.15, seed)
    d[3, :] = np.random.default_rng(seed).standard_normal(640)  # one full row
    d[8:16, :] = 0.0
    d[40:, :] = 0.0
    d[5, :] = 0.0
    return d


MATRICES = {
    "dense-0.3": lambda: _sparse_dense(100, 350, 0.3, 5),
    "dense-0.03": lambda: _sparse_dense(100, 350, 0.03, 5),
    "block-0.25": lambda: _block_sparse(72, 384, 0.25, 7),
    "uneven": lambda: _uneven(9),
    "zero": lambda: np.zeros((20, 30)),
}


# -- the structures ----------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_ell_structure_equals_jax(case):
    """vals, cols, vals_t, rows_t array for array (rows padded to 8, k to a multiple of
    128, padding val 0 and col 0), and the operator's shape and density."""
    d = MATRICES[case]()
    got = ts.ell_from_dense_arrays(d)
    want = js.ell_from_dense_arrays(d)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    op, jop = apt.ELLOperator.from_dense(d, device=CPU), js.ELLOperator.from_dense(d)
    assert op.shape == jop.shape and op.density == jop.density
    assert op.cols.dtype == op.rows_t.dtype == torch.int32


def _held_count(vals, cols, vec=4):
    """K8's row extents counted row by row: one past the last entry that is not (val 0,
    col 0), rounded up to vec, capped at k."""
    k = vals.shape[1]
    out = []
    for v, c in zip(np.asarray(vals), np.asarray(cols)):
        held = np.nonzero((v != 0) | (c != 0))[0]
        n = int(held[-1]) + 1 if held.size else 0
        out.append(min(-(-n // vec) * vec, k))
    return np.array(out, np.int32)


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_ell_row_lengths_count_the_held_entries(case):
    """row_len and row_len_t of from_dense, and of ell_from_numpy over JAX's arrays, equal
    a row-by-row count: empty rows 0, the uneven case's full row k, int32 on the
    operator's device."""
    d = MATRICES[case]()
    jop = js.ELLOperator.from_dense(d)
    carried = apt.ell_from_numpy(*(np.asarray(a) for a in (jop.vals, jop.cols, jop.vals_t,
                                                            jop.rows_t)), jop.shape,
                                 device=CPU, dtype=torch.float64)
    for op in (apt.ELLOperator.from_dense(d, device=CPU), carried):
        for got, v, c in ((op.row_len, jop.vals, jop.cols), (op.row_len_t, jop.vals_t,
                                                               jop.rows_t)):
            assert got.dtype == torch.int32 and got.device.type == CPU
            np.testing.assert_array_equal(np_of(got), _held_count(v, c))
    nnz = (d != 0).sum(axis=1)
    want = np.minimum(-(-nnz // 4) * 4, jop.vals.shape[1])
    np.testing.assert_array_equal(np_of(apt.ELLOperator.from_dense(d, device=CPU).row_len)[
        :d.shape[0]], want)
    if case == "uneven":
        lens = np_of(apt.ELLOperator.from_dense(d, device=CPU).row_len)
        assert lens[5] == 0 and lens[3] == jop.vals.shape[1] == 640


def test_ell_row_lengths_edges():
    """An interior (0, 0) entry is read (only the tail after the last held entry is
    skipped); an entry of val 0 at another column, or of col 0 with a value, is held; a
    NaN value is held; lengths round up to 4 and stop at k (k 130, not a multiple of 4)."""
    k = 130
    vals, cols = np.zeros((8, k)), np.zeros((8, k), np.int32)
    vals[0, :3], cols[0, :3] = [1.0, 0.0, 2.0], [4, 0, 7]      # interior (0, 0): 3 -> 4
    vals[1, 5] = 0.0
    cols[1, 5] = 9                                              # val 0, col 9: held -> 8
    vals[2, 6] = -1.5                                           # col 0 with a value -> 8
    vals[3, 128] = 1.0                                          # 129 -> 132 -> capped 130
    vals[4, :] = 1.0                                            # full
    vals[5, 9] = np.nan                                         # NaN held -> 12
    # row 6: padding only; row 7: one entry at 0 -> 4
    vals[7, 0], cols[7, 0] = 3.0, 11
    want = [4, 8, 8, 130, 130, 12, 0, 4]
    got = ts.held_lengths(torch.as_tensor(vals), torch.as_tensor(cols))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got), want)
    np.testing.assert_array_equal(want, _held_count(vals, cols))
    op = apt.ELLOperator.from_arrays(vals, cols, vals.T[:8].copy(), cols.T[:8].copy(),
                                     (8, 8), device=CPU)
    np.testing.assert_array_equal(np_of(op.row_len), want)
    bf = apt.ELLOperator.from_arrays(vals, cols, vals, cols, (8, k), device=CPU,
                                     dtype=torch.bfloat16)
    np.testing.assert_array_equal(np_of(bf.row_len), want)


def _k8_rule(vals, cols, x, lengths):
    """The rule of K8 on the card, in numpy: row i sums its first lengths[i] entries and
    adds 0 * x[0] once where lengths[i] < k."""
    k = vals.shape[1]
    out = np.empty(vals.shape[0])
    with np.errstate(invalid="ignore"):  # 0 * inf
        for i, n in enumerate(lengths):
            s = np.sum(vals[i, :n] * x[cols[i, :n]])
            out[i] = s + 0.0 * x[0] if n < k else s
    return out


def _full_row_case():
    """Row 0 holds k = 128 entries, none at column 0 (no padding: finite under a
    non-finite x[0]); the other rows fewer, an empty one among them."""
    d = _sparse_dense(24, 300, 0.1, 11)
    d[0, :] = 0.0
    d[0, 1:129] = 1.0 + np.arange(128) / 128
    d[7, :] = 0.0
    return d


@pytest.mark.parametrize("x0", [0.75, np.nan, np.inf])
@pytest.mark.parametrize("case", ["uneven", "dense-0.03", "full-row"])
def test_k8_rule_matches_plain_and_jax(case, x0, rng):
    """Reading only each row's held entries plus one 0 * x[0] where the row has padding
    gives the padded sum: the numpy model of that rule equals ell_matvec_plain and JAX's
    interpret-mode ell_matvec_pallas both ways, NaN pattern included, for a finite, a
    NaN and an infinite x[0]."""
    d = _full_row_case() if case == "full-row" else MATRICES[case]()
    op = apt.ELLOperator.from_dense(d, device=CPU)
    for v, c, lens, n in ((op.vals, op.cols, op.row_len, d.shape[1]),
                          (op.vals_t, op.rows_t, op.row_len_t, d.shape[0])):
        v, c = np_of(v), np_of(c)
        x = rng.standard_normal(n)
        x[0] = x0
        model = _k8_rule(v, c, x, np_of(lens))
        plain = ts.ell_matvec(t64(v), torch.as_tensor(c), t64(x), torch.as_tensor(np_of(lens)))
        want = js.ell_matvec_pallas(jnp.asarray(v), jnp.asarray(c), jnp.asarray(x),
                                    interpret=True)
        _nan_pattern(model, want)
        _nan_pattern(plain, want)
        np.testing.assert_array_equal(np.isinf(model), np.isinf(np.asarray(want)))
    if case == "full-row" and not np.isfinite(x0):
        y = _k8_rule(np_of(op.vals), np_of(op.cols), np.r_[x0, np.ones(299)], np_of(op.row_len))
        assert np.isfinite(y[0]) and np.isnan(y[1:]).all()


def test_lengths_refusals():
    """ell_matvec checks lengths as it checks the other arguments: int32, (m,), the
    same device, contiguous."""
    vals, cols, x = t64(np.ones((8, 128))), torch.zeros((8, 128), dtype=torch.int32), t64(
        np.ones(40))
    lens = torch.full((8,), 128, dtype=torch.int32)
    np.testing.assert_array_equal(np_of(ts.ell_matvec(vals, cols, x, lens)), np.full(8, 128.0))
    with pytest.raises(TypeError, match="lengths must be int32"):
        ts.ell_matvec(vals, cols, x, lens.long())
    with pytest.raises(ValueError, match="lengths must be"):
        ts.ell_matvec(vals, cols, x, lens[:4])
    with pytest.raises(ValueError, match="and contiguous; got .* contiguous False"):
        ts.ell_matvec(vals, cols, x, torch.full((8, 2), 128, dtype=torch.int32)[:, 0])


@pytest.mark.parametrize("block", [(8, 128), (64, 512), (16, 256)])
@pytest.mark.parametrize("case", sorted(MATRICES))
def test_bcsr_structure_equals_jax(case, block):
    """bcsr_from_dense's (vals, cols, rowptr, padded shape) and the operator's derived
    fields (rows, max_bpr, the A' structure) as JAX's, an all-zero matrix (one zero tile)
    and empty and trailing empty block rows included."""
    d = MATRICES[case]()
    got, want = tb.bcsr_from_dense(d, *block), jb.bcsr_from_dense(d, *block)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    op, jop = apt.BCSROperator.from_dense(d, block, device=CPU), jb.BCSROperator.from_dense(d, block)
    for name in ("vals", "cols", "rowptr", "rows", "vals_t", "cols_t", "rowptr_t", "rows_t"):
        np.testing.assert_array_equal(np_of(getattr(op, name)), np.asarray(getattr(jop, name)))
    assert (op.shape, op.padded_shape, op.max_bpr, op.max_bpr_t, op.kernel) == (
        jop.shape, jop.padded_shape, jop.max_bpr, jop.max_bpr_t, jop.kernel)
    assert op.block_density == jop.block_density
    np.testing.assert_allclose(tb.bcsr_matvec_ref(*got[:3], np.ones(got[3][1])),
                               np.asarray(jb.bcsr_matvec_ref(*want[:3], np.ones(want[3][1]))),
                               rtol=1e-15, atol=0)


# -- the matvecs ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dense-0.3", "dense-0.03", "uneven"])
def test_ell_matvec_matches_jax_kernel(case, rng):
    """K8's plain version (ell_matvec on CPU tensors) against JAX's interpret-mode
    ell_matvec_pallas, both directions, all padded rows."""
    d = MATRICES[case]()
    vals, cols, vals_t, rows_t = ts.ell_from_dense_arrays(d)
    for v, c, n in ((vals, cols, d.shape[1]), (vals_t, rows_t, d.shape[0])):
        x = rng.standard_normal(n)
        got = ts.ell_matvec(t64(v), torch.as_tensor(c), t64(x))
        want = js.ell_matvec_pallas(jnp.asarray(v), jnp.asarray(c), jnp.asarray(x),
                                    interpret=True)
        assert got.shape == (v.shape[0],)
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_bcsr_matvec_matches_jax_kernel(rng):
    """K9a's plain version (bcsr_matvec on CPU tensors) against JAX's interpret-mode
    bcsr_matvec, with uneven block rows, an empty and a trailing empty block row."""
    for d in (_block_sparse(64, 512, 0.2, 5), _uneven(9)):
        vals, cols, rowptr, (_, npd) = tb.bcsr_from_dense(d, 8, 128)
        x = rng.standard_normal(npd)
        max_bpr = max(1, int(np.diff(rowptr).max()))
        got = tb.bcsr_matvec(t64(vals), torch.as_tensor(cols), torch.as_tensor(rowptr),
                             max_bpr, t64(x))
        want = jb.bcsr_matvec(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(rowptr),
                              max_bpr, jnp.asarray(x), interpret=True)
        np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("slab", [4, 8])
def test_bcsr_slab_matches_jax_kernel(slab, rng):
    """K9b's plain version (bcsr_matvec_slab on CPU tensors) against JAX's
    interpret-mode bcsr_matvec_slab: a tile count that is not a slab multiple, an empty
    block row."""
    d = _block_sparse(128, 1024, 0.25, 13)
    d[16:24, :] = 0.0
    vals, cols, rowptr, (_, npd) = tb.bcsr_from_dense(d, 8, 128)
    assert vals.shape[0] % slab  # the zero-tile padding is exercised
    rows = tb.block_rows(rowptr)
    x = rng.standard_normal(npd)
    got = tb.bcsr_matvec_slab(t64(vals), torch.as_tensor(cols), torch.as_tensor(rows),
                              len(rowptr) - 1, t64(x), slab=slab)
    want = jb.bcsr_matvec_slab(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(rows),
                               len(rowptr) - 1, jnp.asarray(x), slab=slab, interpret=True)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kernel", list(tb.KERNELS) + ["ell"])
@pytest.mark.parametrize("case", ["dense-0.3", "block-0.25", "uneven"])
def test_operators_against_dense(case, kernel, rng):
    """Both directions of each operator (and each BCSR route) against d @ x and d' @ y,
    at test_sparse.py's and test_bcsr.py's tolerances; the default (64, 512) tiles and
    (8, 128) ones."""
    d = MATRICES[case]()
    m, n = d.shape
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    if kernel == "ell":
        ops = [apt.ELLOperator.from_dense(d, device=CPU)]
    else:
        ops = [apt.BCSROperator.from_dense(d, block, kernel, device=CPU)
               for block in ((8, 128), (64, 512))]
    for op in ops:
        np.testing.assert_allclose(np_of(op.matvec(t64(x))), d @ x, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np_of(op.rmatvec(t64(y))), d.T @ y, rtol=1e-9, atol=1e-11)


def test_bf16_storage_accumulates_in_f32(rng):
    """bf16 vals with an f32 x: the products and the sums in f32, as JAX's XLA routes
    (ell_matvec_xla, bcsr_matvec_xla) take them; rtol 1e-5 for f32 sums in another
    order."""
    d = _block_sparse(72, 384, 0.3, 7)
    x = rng.standard_normal(384).astype(np.float32)
    y = rng.standard_normal(72).astype(np.float32)
    jell = js.ELLOperator.from_dense(d.astype(np.float32))
    jell = js.ELLOperator(vals=jell.vals.astype(jnp.bfloat16), cols=jell.cols,
                          vals_t=jell.vals_t.astype(jnp.bfloat16), rows_t=jell.rows_t,
                          shape=jell.shape)
    ell = apt.ELLOperator.from_dense(d.astype(np.float32), device=CPU, dtype=torch.bfloat16)
    jops = [jell] + [jb.BCSROperator.from_dense(d.astype(np.float32).astype(jnp.bfloat16),
                                                kernel="xla")]
    ops = [ell] + [apt.BCSROperator.from_dense(d.astype(np.float32), kernel=k, device=CPU,
                                               dtype=torch.bfloat16) for k in tb.KERNELS]
    for op in ops:
        jop = jops[0] if op is ell else jops[1]
        assert op.vals.dtype == torch.bfloat16
        for fn, v in (("matvec", x), ("rmatvec", y)):
            got = getattr(op, fn)(torch.as_tensor(v))
            want = np.asarray(getattr(jop, fn)(jnp.asarray(v)))
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_allclose(np_of(got), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def _nan_pattern(got, want):
    got, want = np_of(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)


def test_non_finite_x_follows_jax(rng):
    """A NaN or an inf in x reaches exactly the rows it reaches in JAX: ELL's padding
    entries (val 0, col 0) carry x[0] into every padded row; a BCSR tile carries a
    non-finite x block into its whole block row; K9b's zero padding tiles carry column
    block 0 into block row 0, which holds no tile of that column here."""
    d = _block_sparse(64, 512, 0.2, 5)
    d[:8, :128] = 0.0  # block row 0 stores no tile of column block 0
    vals, cols, vals_t, rows_t = ts.ell_from_dense_arrays(d)
    for bad in (np.nan, np.inf):
        x = rng.standard_normal(512)
        x[0] = bad
        got = ts.ell_matvec(t64(vals), torch.as_tensor(cols), t64(x))
        _nan_pattern(got, js.ell_matvec_pallas(jnp.asarray(vals), jnp.asarray(cols),
                                               jnp.asarray(x), interpret=True))
        assert np.isnan(np_of(got)).any()
        bv, bc, brp, _ = tb.bcsr_from_dense(d, 8, 128)
        rows = tb.block_rows(brp)
        slab = 8
        assert bv.shape[0] % slab
        got = tb.bcsr_matvec_slab(t64(bv), torch.as_tensor(bc), torch.as_tensor(rows),
                                  len(brp) - 1, t64(x), slab=slab)
        _nan_pattern(got, jb.bcsr_matvec_slab(jnp.asarray(bv), jnp.asarray(bc),
                                              jnp.asarray(rows), len(brp) - 1, jnp.asarray(x),
                                              slab=slab, interpret=True))
        assert np.isnan(np_of(got)[:8]).all()  # the padding's row-0 NaN
        got = tb.bcsr_matvec(t64(bv), torch.as_tensor(bc), torch.as_tensor(brp),
                             int(np.diff(brp).max()), t64(x))
        _nan_pattern(got, jb.bcsr_matvec(jnp.asarray(bv), jnp.asarray(bc), jnp.asarray(brp),
                                         int(np.diff(brp).max()), jnp.asarray(x),
                                         interpret=True))
        assert np.isfinite(np_of(got)[:8]).all()  # K9a has no padding tiles
        for kernel in tb.KERNELS:
            op = apt.BCSROperator.from_dense(d, (8, 128), kernel, device=CPU)
            jop = jb.BCSROperator.from_dense(d, (8, 128), kernel="xla")
            want = jop.matvec(jnp.asarray(x))
            if kernel == "slab":
                want = want.at[:8].set(jnp.nan)
            _nan_pattern(op.matvec(t64(x)), want)


def test_refusals():
    """ell_matvec refuses m % 8 != 0 as JAX's kernel does; wrong index dtypes, shapes and
    kernel names raise."""
    vals, cols = np.ones((12, 128)), np.zeros((12, 128), np.int32)
    x = np.ones(40)
    with pytest.raises(ValueError, match="m % 8"):
        js.ell_matvec_pallas(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
                             interpret=True)
    with pytest.raises(ValueError, match="m % 8"):
        ts.ell_matvec(t64(vals), torch.as_tensor(cols), t64(x))
    with pytest.raises(TypeError, match="int32"):
        ts.ell_matvec(t64(vals[:8]), torch.as_tensor(cols[:8]).long(), t64(x))
    with pytest.raises(ValueError, match="need vals"):
        ts.ell_matvec(t64(vals[:8]), torch.as_tensor(cols[:8, :64]), t64(x))
    bv, bc, brp, _ = tb.bcsr_from_dense(np.eye(16), 8, 128)
    with pytest.raises(ValueError, match="whole blocks"):
        tb.bcsr_matvec(t64(bv), torch.as_tensor(bc), torch.as_tensor(brp), 1, t64(np.ones(100)))
    with pytest.raises(ValueError, match="max_bpr"):
        tb.bcsr_matvec(t64(bv), torch.as_tensor(bc), torch.as_tensor(brp), 0, t64(np.ones(128)))
    with pytest.raises(TypeError, match="int32"):
        tb.bcsr_matvec_slab(t64(bv), torch.as_tensor(bc), torch.as_tensor(brp[:-1]).long(), 2,
                            t64(np.ones(128)))
    with pytest.raises(ValueError, match="kernel must be"):
        apt.BCSROperator.from_dense(np.eye(16), kernel="cusparse", device=CPU)


# -- A'y over A's own tiles (the kernel routes' formulation) --------------------------------


def _tile_mask(d, bm, bn):
    """The (nbr, nbc) mask of the nonzero (bm, bn) tiles of d, zero-padded to whole tiles
    (an all-zero matrix stores its one zero tile at (0, 0))."""
    m, n = d.shape
    dp = np.zeros((-(-m // bm) * bm, -(-n // bn) * bn))
    dp[:m, :n] = d
    mask = (dp.reshape(dp.shape[0] // bm, bm, -1, bn) != 0).any(axis=(1, 3))
    if not mask.any():
        mask[0, 0] = True
    return mask


@pytest.mark.parametrize("block", [(8, 128), (64, 512), (16, 256)])
@pytest.mark.parametrize("case", sorted(MATRICES))
def test_bcsr_column_index_is_the_csc_of_the_tile_mask(case, block):
    """colptr / col_tiles against a numpy CSC of the tile mask (each block column's tile
    ids, numbered block-row-major, in increasing order), on the operator built by
    from_dense and by bcsr_from_numpy from JAX's arrays."""
    d = MATRICES[case]()
    mask = _tile_mask(d, *block)
    ids = np.full(mask.shape, -1)
    ids[mask] = np.arange(mask.sum())  # row-major: the tile order of vals
    want_ptr = np.concatenate([[0], np.cumsum(mask.sum(axis=0))])
    want_tiles = np.concatenate([ids[mask[:, c], c] for c in range(mask.shape[1])])
    jop = jb.BCSROperator.from_dense(d, block)
    carried = apt.bcsr_from_numpy(*(np.asarray(a) for a in (jop.vals, jop.cols, jop.rowptr,
                                                             jop.vals_t, jop.cols_t,
                                                             jop.rowptr_t)),
                                  jop.shape, device=CPU, dtype=torch.float64)
    for op in (apt.BCSROperator.from_dense(d, block, device=CPU), carried):
        assert op.colptr.dtype == op.col_tiles.dtype == torch.int32
        np.testing.assert_array_equal(np_of(op.colptr), want_ptr)
        np.testing.assert_array_equal(np_of(op.col_tiles), want_tiles)
        assert op.colptr.shape[0] == op.padded_shape[1] // block[1] + 1


@pytest.mark.parametrize("route", ["plain", "pallas", "slab"])
@pytest.mark.parametrize("block", [(8, 128), (64, 512)])
@pytest.mark.parametrize("case", ["dense-0.3", "block-0.25", "uneven", "zero"])
def test_bcsr_rmatvec_over_a_tiles_matches_jax(case, block, route, rng):
    """A'y over A's own tiles (bcsr_rmatvec_plain, and the "pallas" and "slab" routes'
    rmatvec, whose CPU path it is) against JAX's BCSROperator.rmatvec and JAX's
    interpret-mode bcsr_matvec over the A' structure, in f64 at rtol 1e-12 / atol 1e-13:
    ragged shapes, empty and trailing empty block rows, an all-zero matrix."""
    d = MATRICES[case]()
    m, n = d.shape
    y = rng.standard_normal(m)
    op = apt.BCSROperator.from_dense(d, block, "xla" if route == "plain" else route,
                                     device=CPU)
    jop = jb.BCSROperator.from_dense(d, block)
    if route == "plain":
        yp = np.zeros(op.padded_shape[0])
        yp[:m] = y
        got = tb.bcsr_rmatvec_plain(op.vals, op.rows, op.colptr, op.col_tiles, t64(yp),
                                    op.colptr.shape[0] - 1)
        assert got.shape == (op.padded_shape[1],) and got.dtype == torch.float64
        got = got[:n]
    else:
        got = op.rmatvec(t64(y))
    assert got.shape == (n,)
    tol = dict(rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np_of(got), np.asarray(jop.rmatvec(jnp.asarray(y))), **tol)
    yt = np.zeros(-(-m // block[1]) * block[1])  # y padded to A''s block columns
    yt[:m] = y
    want = jb.bcsr_matvec(jop.vals_t, jop.cols_t, jop.rowptr_t, jop.max_bpr_t, jnp.asarray(yt),
                          interpret=True)
    np.testing.assert_allclose(np_of(got), np.asarray(want)[:n], **tol)
    np.testing.assert_allclose(np_of(got), d.T @ y, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("route", ["pallas", "slab"])
@pytest.mark.parametrize("block", [(8, 128), (64, 512)])
@pytest.mark.parametrize("case", ["dense-0.3", "block-0.25", "uneven"])
def test_bcsr_rmatvec_bf16_storage_matches_jax(case, block, route, rng):
    """bf16 vals with an f32 y: A'y over A's tiles against JAX's rmatvec over the bf16 A'
    structure (products and sums in f32), rtol 1e-5 of the largest output."""
    d = MATRICES[case]().astype(np.float32)
    y = rng.standard_normal(d.shape[0]).astype(np.float32)
    op = apt.BCSROperator.from_dense(d, block, route, device=CPU, dtype=torch.bfloat16)
    jop = jb.BCSROperator.from_dense(d.astype(jnp.bfloat16), block)
    got = op.rmatvec(torch.as_tensor(y))
    want = np.asarray(jop.rmatvec(jnp.asarray(y)))
    assert op.vals.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("route", list(tb.KERNELS))
def test_non_finite_y_pattern_of_each_route(route, bad, rng):
    """The decided reach of a non-finite y[r]: on the kernel routes ("pallas", "slab",
    A'y over A's tiles) every output of each block column that has a tile in r's block
    row, and no other; the "xla" route keeps JAX's pattern over A''s tiles (its
    rmatvec's, NaN for NaN and non-finite for inf)."""
    d = _block_sparse(64, 512, 0.3, 5)
    block = (8, 128)
    mask = _tile_mask(d, *block)
    op = apt.BCSROperator.from_dense(d, block, route, device=CPU)
    jop = jb.BCSROperator.from_dense(d, block)
    for r in (3, 20, 63):
        y = rng.standard_normal(64)
        y[r] = bad
        got = np_of(op.rmatvec(t64(y)))
        if route == "xla":
            want = np.asarray(jop.rmatvec(jnp.asarray(y)))
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-10, atol=1e-12)
        else:
            reach = np.repeat(mask[r // block[0]], block[1])[:512]
            assert reach.any() and not reach.all()
            np.testing.assert_array_equal(~np.isfinite(got), reach)
            if np.isnan(bad):
                assert np.isnan(got[reach]).all()
            np.testing.assert_allclose(got[~reach], (d.T @ np.nan_to_num(y, posinf=0.0))[~reach],
                                       rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("entry", ["bcsr_rmatvec", "bcsr_rmatvec_slab"])
def test_rmatvec_refusals(entry):
    """The A'y entries refuse int64 index arrays, a y that is not whole blocks of bm, a
    colptr of the wrong length and tensors on different devices."""
    fn = getattr(tb, entry)
    op = apt.BCSROperator.from_dense(_block_sparse(16, 256, 0.5, 3), (8, 128), device=CPU)
    args = [op.vals, op.rows, op.colptr, op.col_tiles, op.colptr.shape[0] - 1]
    y = t64(np.ones(16))
    assert fn(*args, y).shape == (256,)
    for k in (1, 2, 3):
        bad = list(args)
        bad[k] = bad[k].long()
        with pytest.raises(TypeError, match="int32"):
            fn(*bad, y)
    with pytest.raises(ValueError, match="whole blocks"):
        fn(*args, t64(np.ones(12)))
    with pytest.raises(ValueError, match="block columns"):
        fn(*args[:4], 3, y)
    with pytest.raises(ValueError, match="different devices"):
        fn(*args, torch.ones(16, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="need vals"):
        fn(op.vals[0], *args[1:], y)


# -- the norms -----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_opnorm2_start_vector_is_jax_draw(dtype):
    """opnorm2 starts from jax.random.normal(PRNGKey(0), (n,)): the numpy copy's draw
    (``utils.jax_random``) is JAX's to within 3 ulps (its documented limit: XLA's log
    rounds otherwise than numpy's in a few ulps), its uniform bits exactly."""
    for n in (140, 350, 384, 16384):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), dtype=dtype))
        got = normal(0, (n,), dtype)
        assert got.dtype == want.dtype
        ulp = np.spacing(np.abs(want).astype(dtype))
        assert np.all(np.abs(got - want) <= 3 * ulp)


@pytest.mark.parametrize("kind", ["ell", "bcsr", "dense"])
@pytest.mark.parametrize("case", ["dense-0.3", "block-0.25", "zero"])
def test_norms_match_jax(case, kind):
    """norm() (Frobenius) and opnorm(600) of the same operator on both sides (the power
    iteration from JAX's draw); a zero operator's opnorm is 0, not NaN."""
    d = MATRICES[case]()
    if kind == "ell":
        op, jop = apt.ELLOperator.from_dense(d, device=CPU), js.ELLOperator.from_dense(d)
    elif kind == "bcsr":
        op, jop = (apt.BCSROperator.from_dense(d, (8, 128), device=CPU),
                   jb.BCSROperator.from_dense(d, (8, 128)))
    else:
        op, jop = apt.DenseOperator(t64(d)), ap.DenseOperator(a=jnp.asarray(d))
    if kind != "dense":
        np.testing.assert_allclose(float(op.norm()), float(jop.norm()), rtol=1e-14)
    got, want = float(op.opnorm(iters=600)), float(jop.opnorm(iters=600))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(got, np.linalg.norm(d, 2), rtol=1e-3)
    assert got == want == 0.0 if case == "zero" else got > 0


@pytest.mark.parametrize("kind", ["ell", "bcsr"])
@pytest.mark.parametrize("case", ["dense-0.3", "block-0.25", "uneven"])
def test_bf16_norm_matches_jax(case, kind):
    """bf16 vals: the norm is JAX's, a bf16 number (the squares rounded to bf16,
    summed in f32, the sum rounded to bf16, then the root), to one bf16 ulp."""
    d = MATRICES[case]().astype(np.float32)
    if kind == "ell":
        op = apt.ELLOperator.from_dense(torch.from_numpy(d), device=CPU, dtype=torch.bfloat16)
        jop = js.ELLOperator.from_dense(d.astype(jnp.bfloat16))
    else:
        op = apt.BCSROperator.from_dense(torch.from_numpy(d), (8, 128), device=CPU,
                                         dtype=torch.bfloat16)
        jop = jb.BCSROperator.from_dense(d.astype(jnp.bfloat16), (8, 128))
    got, want = op.norm(), jop.norm()
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    ulp = float(np.spacing(np.float32(want)) * 2 ** 16)  # bf16 keeps 8 of f32's 24 bits
    assert abs(float(got) - float(want)) <= ulp


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
def test_storage_norm_matches_jnp_linalg_norm(dtype):
    """fused_condat_vu's default norm_A: JAX takes jnp.linalg.norm of A' in its
    storage dtype; the port's storage_norm gives the same number."""
    rng = np.random.default_rng(3)
    for shape in ((16, 512), (64, 1000), (300, 7)):
        a = rng.standard_normal(shape).astype(np.float32)
        want = jnp.linalg.norm(jnp.asarray(a, getattr(jnp, dtype)))
        got = apt.ops.linops.storage_norm(torch.from_numpy(a).to(getattr(torch, dtype)))
        assert str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6 if dtype != "bfloat16"
                                   else 0)


def test_opnorm2_dtype_and_refusal():
    """bf16 storage iterates in f32; an operator without a shape needs n=."""
    d = _block_sparse(72, 384, 0.25, 7).astype(np.float32)
    op = apt.ELLOperator.from_dense(d, device=CPU, dtype=torch.bfloat16)
    assert op.opnorm(iters=50).dtype == torch.float32

    class NoShape:
        def matvec(self, x):
            return x

        rmatvec = matvec

    with pytest.raises(ValueError, match="pass n="):
        apt.opnorm2(NoShape())
    assert float(apt.opnorm2(NoShape(), n=5, iters=3)) == pytest.approx(1.0)


# -- the oracles ---------------------------------------------------------------------------


def _operators(d, block=(8, 128)):
    """The port's and JAX's operator pairs over d: ELL, and BCSR by each route."""
    pairs = [(apt.ELLOperator.from_dense(d, device=CPU), js.ELLOperator.from_dense(d))]
    for kernel in tb.KERNELS:
        pairs.append((apt.BCSROperator.from_dense(d, block, kernel, device=CPU),
                      jb.BCSROperator.from_dense(d, block)))
    return pairs


def test_least_squares_over_operators_matches_jax(rng):
    """LeastSquares(a=op): value and gradient against JAX's over the same operator, and
    against the dense tensor's."""
    d = _block_sparse(64, 256, 0.3, 11)
    b, x = rng.standard_normal(64), rng.standard_normal(256)
    dense = apt.LeastSquares(t64(d), t64(b))
    for op, jop in _operators(d):
        f, jf = apt.LeastSquares(op, t64(b)), JLS(a=jop, b=jnp.asarray(b))
        (v, g), (jv, jg) = f.value_and_grad(t64(x)), jf.value_and_grad(jnp.asarray(x))
        np.testing.assert_allclose(float(v), float(jv), rtol=1e-12)
        np.testing.assert_allclose(np_of(g), np.asarray(jg), rtol=1e-10, atol=1e-12)
        dv, dg = dense.value_and_grad(t64(x))
        np.testing.assert_allclose(float(v), float(dv), rtol=1e-10)
        np.testing.assert_allclose(np_of(g), np_of(dg), rtol=1e-9, atol=1e-11)


def test_logistic_over_operators_matches_jax(rng):
    """LogisticLoss(x=op): value and gradient against JAX's over the same operator."""
    x_np, y_np = synthetic_classification(120, 300, seed=2)
    w = rng.standard_normal(301)
    for op, jop in _operators(x_np):
        f, jf = apt.LogisticLoss(op, t64(y_np)), JLogistic(x=jop, y=jnp.asarray(y_np))
        (v, g), (jv, jg) = f.value_and_grad(t64(w)), jf.value_and_grad(jnp.asarray(w))
        np.testing.assert_allclose(float(v), float(jv), rtol=1e-12)
        np.testing.assert_allclose(np_of(g), np.asarray(jg), rtol=1e-10, atol=1e-12)


def test_fused_with_an_operator_raises():
    """fused=True reads a dense A inside K1 / K3: an operator is refused by name, where
    JAX quietly takes the two matvecs."""
    op = apt.ELLOperator.from_dense(np.eye(8), device=CPU)
    with pytest.raises(ValueError, match="ELLOperator"):
        apt.LeastSquares(op, torch.zeros(8, dtype=torch.float64), fused=True)
    bop = apt.BCSROperator.from_dense(np.eye(8), device=CPU)
    with pytest.raises(ValueError, match="BCSROperator"):
        apt.LogisticLoss(bop, torch.zeros(8, dtype=torch.float64), fused=True)


# -- the slice end to end ------------------------------------------------------------------


@pytest.mark.parametrize("route", ["ell"] + list(tb.KERNELS))
def test_lasso_adapgm_over_operator_matches_jax(route, rng):
    """AdaPGM on a lasso over ELL and BCSR (each route) through adaptive_proxgrad, against
    JAX's solve over the same operator: x at test_sparse.py's rtol 1e-7 (ELL, converged to
    tol 1e-9) or test_bcsr.py's rtol 1e-4 (BCSR: its case runs all 2000 iterations, and
    the f64-level drift compounds over them), the final objective at rtol 1e-10 (both).
    numit within 10%, not test_sparse.py's 2%: the adaptive rule amplifies rounding, so the
    iteration count to tol 1e-9 depends on the order of every sum (on the ELL case the
    port's 1183 against JAX's 1229, 3.7%, with x equal to 1.3e-10)."""
    if route == "ell":
        d, x_tol = _sparse_dense(96, 400, 0.08, 9), dict(rtol=1e-7, atol=1e-9)
        op, jop = apt.ELLOperator.from_dense(d, device=CPU), js.ELLOperator.from_dense(d)
    else:
        d, x_tol = _block_sparse(64, 256, 0.3, 11), dict(rtol=1e-4, atol=1e-6)
        op = apt.BCSROperator.from_dense(d, kernel=route, device=CPU)
        jop = jb.BCSROperator.from_dense(d)
    m, n = d.shape
    b = rng.standard_normal(m)
    gamma = 1.0 / float(np.linalg.norm(d, 2) ** 2)
    f, jf = apt.LeastSquares(op, t64(b)), JLS(a=jop, b=jnp.asarray(b))
    res = apt.adaptive_proxgrad(torch.zeros(n, dtype=torch.float64), f=f, g=apt.L1Norm(1.0),
                                rule=apt.AdaPGMRule(gamma=gamma), tol=1e-9, maxit=2000)
    ref = ap.adaptive_proxgrad(jnp.zeros(n), f=jf, g=ap.L1Norm(lam=1.0),
                               rule=ap.AdaPGMRule(gamma=gamma), tol=1e-9, maxit=2000)
    assert abs(res.numit - int(ref.numit)) <= max(2, int(ref.numit) // 10)
    np.testing.assert_allclose(np_of(res.x), np.asarray(ref.x), **x_tol)
    obj = float(f.value(res.x) + apt.L1Norm(1.0)(res.x))
    jobj = float(jf.value(ref.x) + ap.L1Norm(lam=1.0)(ref.x))
    np.testing.assert_allclose(obj, jobj, rtol=1e-10)
    assert res.counters.f_evals == res.counters.grad_f_evals == res.numit + 1


def test_logistic_adapgm_over_ell_matches_jax():
    """The sparse logistic solve over ELL (test_sparse.py:81-107): x at rtol 1e-4, the
    objective at rtol 1e-10 against JAX's over the same operator."""
    x_np, y_np = synthetic_classification(120, 300, seed=2)
    op, jop = apt.ELLOperator.from_dense(x_np, device=CPU), js.ELLOperator.from_dense(x_np)
    f, jf = apt.LogisticLoss(op, t64(y_np)), JLogistic(x=jop, y=jnp.asarray(y_np))
    res = apt.adaptive_proxgrad(torch.zeros(301, dtype=torch.float64), f=f,
                                g=apt.L1Norm(0.01), rule=apt.AdaPGMRule(gamma=1.0), tol=1e-7,
                                maxit=600)
    ref = ap.adaptive_proxgrad(jnp.zeros(301), f=jf, g=ap.L1Norm(lam=0.01),
                               rule=ap.AdaPGMRule(gamma=1.0), tol=1e-7, maxit=600)
    np.testing.assert_allclose(np_of(res.x), np.asarray(ref.x), rtol=1e-4, atol=1e-6)
    obj = float(f.value(res.x) + apt.L1Norm(0.01)(res.x))
    jobj = float(jf.value(ref.x) + ap.L1Norm(lam=0.01)(ref.x))
    np.testing.assert_allclose(obj, jobj, rtol=1e-10)


@pytest.mark.parametrize("route", ["ell", "pallas", "xla"])
def test_sqrt_lasso_pd_over_operator_matches_jax(route, rng):
    """The square-root lasso through adaptive_primal_dual with A an operator (f = 0, g =
    L1Norm(10), h = Translate(L2Norm(1), -y)), as test_sparse.py:110-126 and the
    quickstart's block-sparse example: x at rtol 1e-6 against JAX's over the same
    operator; the A and A' evaluations as the engine counts them (A' is not taken on the
    converging iteration)."""
    if route == "ell":
        d = _sparse_dense(60, 140, 0.1, 13)
        op, jop = apt.ELLOperator.from_dense(d, device=CPU), js.ELLOperator.from_dense(d)
    else:
        d = _block_sparse(64, 512, 0.3, 17)
        op = apt.BCSROperator.from_dense(d, (8, 128), route, device=CPU)
        jop = jb.BCSROperator.from_dense(d, (8, 128))
    m, n = d.shape
    yv = rng.standard_normal(m)
    na = float(np.linalg.norm(d))
    res = apt.adaptive_primal_dual(
        torch.zeros(n, dtype=torch.float64), torch.zeros(m, dtype=torch.float64),
        f=apt.ZeroSmooth(), g=apt.L1Norm(10.0), h=apt.Translate(apt.L2Norm(1.0), -t64(yv)),
        A=op, rule=apt.AdaPGMRule.make(t=1.0, norm_a=na), tol=1e-6, maxit=5000)
    ref = ap.adaptive_primal_dual(
        jnp.zeros(n), jnp.zeros(m), f=ap.ZeroSmooth(), g=ap.L1Norm(lam=10.0),
        h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)), A=jop,
        rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), tol=1e-6, maxit=5000)
    assert res.numit == int(ref.numit) and float(res.norm_res) <= 1e-6
    np.testing.assert_allclose(np_of(res.x), np.asarray(ref.x), rtol=1e-6, atol=1e-8)
    assert (res.counters.A_evals, res.counters.At_evals) == (res.numit + 1, res.numit)


# -- carrying across -----------------------------------------------------------------------


def test_operators_carried_from_jax_arrays(rng):
    """ell_from_numpy and bcsr_from_numpy on a JAX operator's arrays: the same matvecs as
    JAX's operator, int32 indices, and lasso_from_numpy / logreg_from_numpy take them."""
    d = _block_sparse(72, 384, 0.25, 7)
    x, y = rng.standard_normal(384), rng.standard_normal(72)
    jell = js.ELLOperator.from_dense(d)
    ell = apt.ell_from_numpy(*(np.asarray(a) for a in (jell.vals, jell.cols, jell.vals_t,
                                                        jell.rows_t)), jell.shape, device=CPU,
                             dtype=torch.float64)
    jbc = jb.BCSROperator.from_dense(d, (8, 128))
    bc = apt.bcsr_from_numpy(*(np.asarray(a) for a in (jbc.vals, jbc.cols, jbc.rowptr,
                                                        jbc.vals_t, jbc.cols_t, jbc.rowptr_t)),
                             jbc.shape, kernel="pallas", device=CPU, dtype=torch.float64)
    assert (bc.max_bpr, bc.max_bpr_t, bc.padded_shape) == (jbc.max_bpr, jbc.max_bpr_t,
                                                           jbc.padded_shape)
    for op, jop in ((ell, jell), (bc, jbc)):
        assert op.vals.dtype == torch.float64
        idx = ((op.cols, op.rows_t) if op is ell else
               (op.cols, op.rowptr, op.rows, op.cols_t, op.rowptr_t, op.rows_t))
        assert all(t.dtype == torch.int32 for t in idx)
        np.testing.assert_allclose(np_of(op.matvec(t64(x))), np.asarray(jop.matvec(
            jnp.asarray(x))), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(np_of(op.rmatvec(t64(y))), np.asarray(jop.rmatvec(
            jnp.asarray(y))), rtol=1e-12, atol=1e-13)
    f, g = apt.lasso_from_numpy(ell, y, 0.5, device=CPU, dtype=torch.float64, fused=False)
    assert f.a is ell and float(g.lam) == 0.5
    jf = JLS(a=jell, b=jnp.asarray(y))
    np.testing.assert_allclose(float(f.value(t64(x))), float(jf.value(jnp.asarray(x))),
                               rtol=1e-12)
    lf, _ = apt.logreg_from_numpy(bc, (y > 0).astype(float), 0.1, device=CPU,
                                  dtype=torch.float64, fused=False)
    assert lf.x is bc
