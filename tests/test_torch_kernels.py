"""K1's plain version in the PyTorch port against the JAX package's Pallas
kernel ``fused_ls_value_grad`` run in interpret mode on the CPU, on the same
numpy inputs; K1's and K2c's launch plans (``k1_plan``, ``k2c_plan``). The CUDA
kernels themselves are tested on the card (tests/test_torch_cuda.py) and by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

from adaprox_tpu.ops import kernels as jk
from adaprox_tpu_torch.ops import kernels as tk
from adaprox_tpu_torch.ops import resident as tr

SHAPES = [(64, 128), (96, 256), (256, 384)]  # tile-aligned: the Pallas kernel needs it


def _inputs(m, n, seed=0):
    return (gaussian(seed, m, n) / np.sqrt(n), gaussian(seed + 1, m), gaussian(seed + 2, n))


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("store", ["float64", "float32", "bfloat16"])
def test_k1_plain_matches_jax_interpret_kernel(m, n, store):
    a, b, x = _inputs(m, n)
    vec = "float64" if store == "float64" else "float32"
    a_j = jnp.asarray(a, store)
    a_t = torch.from_numpy(a).to(getattr(torch, store))
    # bf16 storage: both sides must start from the same rounded values
    np.testing.assert_array_equal(np.asarray(a_j.astype(jnp.float64)),
                                  a_t.double().numpy())
    f_j, g_j = jk.fused_ls_value_grad(a_j, jnp.asarray(b, vec), jnp.asarray(x, vec),
                                      interpret=True)
    b_t = torch.from_numpy(b).to(getattr(torch, vec))
    x_t = torch.from_numpy(x).to(getattr(torch, vec))
    launches = tk.fused_ls_value_grad.launches
    for f_t, g_t in (tk.ls_value_grad_plain(a_t, b_t, x_t),
                     tk.fused_ls_value_grad(a_t, b_t, x_t)):
        assert f_t.dtype == b_t.dtype and g_t.dtype == b_t.dtype and g_t.shape == (n,)
        # f64: both sides differ only in summation order, ~n * eps; f32 (also
        # bf16 storage, accumulated in f32): the same for eps = 6e-8
        rtol = 1e-12 if vec == "float64" else 1e-5
        np.testing.assert_allclose(float(f_t), float(f_j), rtol=rtol)
        g_ref = np_of(g_j)
        np.testing.assert_allclose(np_of(g_t), g_ref, rtol=0,
                                   atol=rtol * np.abs(g_ref).max())
    # CPU tensors take the plain version: no kernel launch is counted
    assert tk.fused_ls_value_grad.launches == launches


@pytest.mark.parametrize("m,n", [(1, 1), (7, 5), (1000, 300), (999, 301)])
def test_k1_plain_any_shape_matches_numpy(m, n):
    """The CUDA kernel takes any (m, n); its plain version does too (the
    Pallas kernel's tile rule has no counterpart in the port)."""
    a, b, x = _inputs(m, n, seed=3)
    f_t, g_t = tk.fused_ls_value_grad(*(torch.from_numpy(v) for v in (a, b, x)))
    res = a @ x - b
    np.testing.assert_allclose(float(f_t), 0.5 * res @ res, rtol=1e-12)
    np.testing.assert_allclose(np_of(g_t), a.T @ res, rtol=1e-11, atol=1e-13)


def test_k1_wrapper_rejects_bad_arguments():
    a, b, x = (torch.from_numpy(v) for v in _inputs(8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        tk.fused_ls_value_grad(a, b[:-1], x)
    with pytest.raises(ValueError, match="need a"):
        tk.fused_ls_value_grad(a[0], b, x)
    # neither CPU nor CUDA: no plain fall-back, no kernel
    with pytest.raises(ValueError, match="CPU .* or CUDA"):
        tk.fused_ls_value_grad(a.to("meta"), b.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        tk.fused_ls_value_grad(a, b.to("meta"), x)


def test_k1_source_and_build_key():
    """The kernel is built from the repo's CUDA source for sm_90a, into the
    package's build directory, keyed on the source's content."""
    src = tk.SOURCE.read_text()
    assert "__global__" in src and "adaprox_fused_ls" in src
    assert "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS
    assert tk.BUILD_DIR.name == "_build" and tk.BUILD_DIR.parent == tk.SOURCE.parent.parent
    # no library kernel stands in for the hand-written one
    body = src.split("#include <stdint.h>", 1)[1]
    for banned in ("cublas", "wmma", "mma.sync", "torch"):
        assert banned not in body


# -- K1's plan (ops/kernels.py::k1_plan): what the CUDA kernel is launched with --------------

K1_MS = [1, 2, 7, 15, 16, 17, 263, 265, 517, 999, 4000, 16384, 100003]
K1_NS = [1, 5, 300, 301, 1023, 1024, 1025, 1028, 1032, 2048, 4096, 16383, 16384, 16385, 16388,
         16392, 20001, 65536, 131072]
K1_SMS = [1, 8, 66, 132, 144]


def _k1_rows_of_each_cta(plan, m):
    """The rows each CTA (each cluster: its CTAs share their rows) takes, in order, as
    csrc/fused_ls.cu deals them: slots c, c + clusters, ..., each slot's rows in order."""
    clusters = plan["grid"] // plan["cluster"]
    rps = plan["rows_per_slot"]
    return [[r for s in range(c, plan["slots"], clusters)
             for r in range(s * rps, min(m, (s + 1) * rps))] for c in range(clusters)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", K1_NS)
def test_k1_plan_covers_every_row_and_column_once(n, itemsize):
    lanes = 16 // itemsize
    nvec = -(-n // lanes)
    for m in K1_MS:
        for sms in K1_SMS:
            plan = tk.k1_plan(m, n, itemsize, sms)
            assert set(plan) == set(tk.K1_PLAN_KEYS)
            assert plan["slots"] == -(-m // plan["rows_per_slot"])
            assert plan["rows_per_slot"] * (plan["slots"] - 1) < m
            c = plan["cluster"]
            assert c in (1, 2, 4, 8) and plan["grid"] % c == 0
            assert c <= plan["grid"] <= c * plan["slots"]
            if m <= 4000:
                rows = sorted(r for cta in _k1_rows_of_each_cta(plan, m) for r in cta)
                assert rows == list(range(m))
            if plan["regime"] == "rows":
                assert n <= tk.K1_NARROW_N and c == 1 and plan["threads"] == 256
                # a warp's 32 lanes hold k values each: the whole (zero-padded) row
                assert plan["k"] in (8, 16, 32) and plan["k"] % lanes == 0
                assert 32 * plan["k"] >= nvec * lanes
                assert plan["rows_per_slot"] >= tk.K1_ROW_MIN_SLOT
            else:
                assert n > tk.K1_NARROW_N and plan["k"] == tk.K1_RING_COLS
                # the ranks' column slices: whole vectors, none empty, every vector once
                sv = plan["slice_vec"]
                slices = [range(r * sv, min(nvec, (r + 1) * sv)) for r in range(c)]
                assert all(len(sl) > 0 for sl in slices)
                assert [v for sl in slices for v in sl] == list(range(nvec))
                t = plan["threads"]
                assert t % 32 == 0 and 32 <= t <= 1024 and t * (16 // lanes) >= sv > t * (
                    16 // lanes) - 32 * (16 // lanes)
                assert plan["stride"] % 16 == 0 and plan["stride"] >= 16 * sv + 16
                assert plan["rows_per_slot"] >= tk.K1_RING_MIN_SLOT


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", K1_NS)
def test_k1_plan_fits_shared_memory(n, itemsize):
    """Every plan fits a CTA's 227 KB (the opt-in) and, at the CTAs an SM it counts on, the
    SM's 228 KB; the ring holds at least two rows (one in flight while one is read)."""
    for m in (1, 999, 16384):
        plan = tk.k1_plan(m, n, itemsize, 132)
        if plan["regime"] == "rows":
            assert plan["smem"] <= 48 * 1024  # static shared memory
            assert 2 * (plan["smem"] + tk.K1_CTA_RESERVED) <= tk.K1_SM_SMEM
            continue
        per_sm = max(1, min(8, 1024 // plan["threads"]))
        assert 2 <= plan["stages"] <= tk.K1_MAX_STAGES
        assert plan["smem"] == plan["stages"] * plan["stride"]
        assert plan["smem"] + tk.K1_RING_STATIC <= tk.K1_CTA_SMEM
        assert per_sm * (plan["smem"] + tk.K1_RING_STATIC + tk.K1_CTA_RESERVED) <= tk.K1_SM_SMEM


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("m,n", [(1, 1), (4000, 1024), (999, 301), (16384, 16384), (517, 2048),
                                 (37, 20001), (9, 131072)])
def test_k1_plan_slots_depend_on_the_shape_alone(m, n, itemsize):
    """Only the grid follows the card: every number that sets the arithmetic, and so the
    bits, is the same on any number of SMs."""
    plans = [tk.k1_plan(m, n, itemsize, sms) for sms in K1_SMS]
    shape_only = [{k: v for k, v in p.items() if k != "grid"} for p in plans]
    assert all(p == shape_only[0] for p in shape_only)


def test_k1_plan_thresholds_and_refusals():
    assert tk.k1_plan(4000, 1024, 4, 132)["regime"] == "rows"
    assert tk.k1_plan(4000, 1028, 4, 132)["regime"] == "ring"
    assert tk.k1_plan(4000, 1032, 2, 132)["regime"] == "ring"
    for itemsize in (4, 2):
        assert tk.k1_plan(8, 16384, itemsize, 132)["cluster"] == 1
        assert tk.k1_plan(8, 16384 + 16 // itemsize, itemsize, 132)["cluster"] == 2
        assert tk.k1_plan(8, 131072, itemsize, 132)["cluster"] == 8
        with pytest.raises(ValueError, match="on chip"):
            tk.k1_plan(8, 131073, itemsize, 132)
    # the headline: one CTA an SM, a three-deep ring of 64 KB rows (f32), seven of 32 KB (bf16)
    head = tk.k1_plan(16384, 16384, 4, 132)
    assert (head["threads"], head["stages"], head["grid"]) == (1024, 3, 132)
    bf16 = tk.k1_plan(16384, 16384, 2, 132)
    assert bf16["stages"] == 7
    assert head["slots"] == bf16["slots"] == 132  # one slot of 125 rows an SM
    for bad in ((0, 4, 4, 132), (4, 0, 4, 132), (4, 4, 8, 132), (4, 4, 4, 0)):
        with pytest.raises(ValueError):
            tk.k1_plan(*bad)


# -- K2c's plan (ops/resident.py::k2c_plan): its lockstep groups ----------------------------

K2C_COUNTS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 33]
K2C_SHAPES = [(4000, 1024), (8128, 128), (128, 128), (8, 2176), (1, 1)]


def _k2c_rows(count, seed=0):
    """A (count, 5) table: the menu's rules, momentum on about a third of the rows."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.1, 1.0, count), rng.integers(0, 3, count),
                     (rng.random(count) < 0.35).astype(float), np.full(count, 1e-6),
                     rng.integers(0, 400, count)], 1)


@pytest.mark.parametrize("count", K2C_COUNTS)
def test_k2c_plan_puts_every_row_in_one_group_in_table_order(count):
    plan = tr.k2c_plan(_k2c_rows(count), 4000, 1024, 4, 132)
    assert set(plan) == set(tr.K2C_PLAN_KEYS)
    groups = plan["groups"]
    assert [j for grp in groups for j in grp] == list(range(count))
    assert all(1 <= len(grp) <= tr.K2C_GROUP for grp in groups)
    # full groups first: only the last may hold fewer rows
    assert all(len(grp) == tr.K2C_GROUP for grp in groups[:-1])
    assert len(groups) == -(-count // tr.K2C_GROUP)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("count", K2C_COUNTS)
def test_k2c_plan_syncs_four_exactly_with_a_momentum_row(count, seed):
    rows = _k2c_rows(count, seed)
    plan = tr.k2c_plan(rows, 4000, 1024, 4, 132)
    for grp, syncs, passes in zip(plan["groups"], plan["syncs"], plan["row_passes"]):
        assert syncs == (4 if any(rows[j, 2] > 0 for j in grp) else 3)
        assert passes == -(-len(grp) // 2)  # the rows two at a time over each row of A


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("m,n", K2C_SHAPES)
def test_k2c_plan_follows_sms_only_through_the_grid(m, n, itemsize):
    """The grid and the partials' scratch follow the card; nothing else does, so a row's
    bits (K2's order on K2's grid) follow from the shape, the dtype and its own arguments."""
    rows = _k2c_rows(9)
    plans = [tr.k2c_plan(rows, m, n, itemsize, sms) for sms in K1_SMS]
    shape_only = [{k: v for k, v in p.items() if k not in ("grid", "scratch")} for p in plans]
    assert all(p == shape_only[0] for p in shape_only)
    for sms, plan in zip(K1_SMS, plans):
        assert plan["grid"] == min(-(-max(m, n) // tr.K2C_WARPS), sms)
        g0 = len(plan["groups"][0])
        assert plan["scratch"] == dict(xs=(g0, 2, n), gs=(g0, 2, n), v=(g0, n), res=(g0, m),
                                       part=g0 * tr.K2C_PARTS * sms)
        # the C entry's check: kParts partials of each row of a group for each CTA
        assert plan["scratch"]["part"] >= tr.K2C_PARTS * g0 * plan["grid"]
        assert plan["a_bytes"] == m * n * itemsize


def test_k2c_plan_takes_what_the_sweep_takes_and_refuses_the_rest():
    rows = tr.rule_rows([(0.1, "fixed", False), (0.1, "fixed", True)], tol=1e-6, maxit=10)
    checked = tr._sweep_rows(rows, 10, torch.float64)
    assert tr.k2c_plan(rows, 64, 128, 4, 132) == tr.k2c_plan(checked, 64, 128, 4, 132)
    for bad in ((0, 4, 4, 132), (4, 0, 4, 132), (4, 4, 8, 132), (4, 4, 4, 0)):
        with pytest.raises(ValueError):
            tr.k2c_plan(rows, *bad)
    with pytest.raises(ValueError, match=r"\(R >= 1, 5\)"):
        tr.k2c_plan(np.zeros((3, 4)), 64, 128, 4, 132)
