"""The stream probes K10a-c of the PyTorch port (``ops/kernels.py``:
``hbm_read_reduce``, ``hbm_copy``, ``hbm_dma_read``) and the profiling
helpers (``utils/profiling.py``) against the JAX package, on the same numpy
inputs, on the CPU.

K10b and K10c are held against JAX's public entries in interpret mode, with
the configurations and refusals of tests/test_kernels.py. JAX's
``hbm_read_reduce`` has no interpret argument (and refuses the CPU), so its
body ``_stream_kernel`` runs here through ``pl.pallas_call(...,
interpret=True)`` with the wrapper's grid and block specs, copied below. The
CUDA kernels themselves are tested on the card (tests/test_torch_cuda.py)
and by chip_smoke.py.

Tolerance: each probe sums in f32 in its own order, so sums are held to a
relative 1e-5 of the sum of the absolute values they add.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaprox_tpu.ops import kernels as jk
from adaprox_tpu.utils import profiling as jprof
from adaprox_tpu_torch.ops import kernels as tk
from adaprox_tpu_torch.utils import profiling as tprof

RTOL = 1e-5


def _jax_read_reduce(a, scale, block_rows, repeats):
    """JAX's hbm_read_reduce (adaprox_tpu/ops/kernels.py:172-200) with
    interpret=True: its grid, block specs and final sum."""
    m, n = a.shape
    scale2 = jnp.asarray(scale, jnp.float32).reshape(1, 1)
    out = pl.pallas_call(
        jk._stream_kernel,
        grid=(repeats, m // block_rows),
        in_specs=[
            pl.BlockSpec((block_rows, n), lambda k, i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1), lambda k, i: (0, 0), memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((1, n), lambda k, i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, n), jnp.float32),
        interpret=True,
    )(a, scale2)
    return jnp.sum(out)


def _array(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _abs_sum(t):
    return float(torch.sum(torch.abs(t.to(torch.float64))))


@pytest.mark.parametrize("m,n", [(64, 256), (128, 384), (2048, 1024)])
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_pick_block_rows_matches_jax(m, n, itemsize):
    assert tk.pick_block_rows(m, n, itemsize) == jk.pick_block_rows(m, n, itemsize)


@pytest.mark.parametrize("dtype,block_rows,repeats,scale", [
    ("float32", 16, 2, 2.0), ("float32", None, 1, 1.0), ("float32", 8, 3, -0.5),
    ("bfloat16", 16, 2, 2.0), ("bfloat16", None, 2, 0.25)])
def test_read_reduce_matches_jax_body(dtype, block_rows, repeats, scale):
    aj, at = _array((64, 256), dtype)
    tm = block_rows or jk.pick_block_rows(64, 256, at.element_size())
    want = float(_jax_read_reduce(aj, scale, tm, repeats))
    launches = tk.hbm_read_reduce.launches
    got = tk.hbm_read_reduce(at, scale=scale, block_rows=block_rows, repeats=repeats)
    assert tk.hbm_read_reduce.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == ()
    scale_ = abs(scale) * repeats * _abs_sum(at)
    assert abs(float(got) - want) <= RTOL * scale_
    # the closed form in f64
    closed = repeats * scale * float(torch.sum(at.to(torch.float64)))
    assert abs(float(got) - closed) <= RTOL * scale_


def test_read_reduce_refuses_what_jax_refuses():
    aj, at = _array((64, 256), "float32")
    with pytest.raises(ValueError, match="does not divide"):
        jk.hbm_read_reduce(aj, block_rows=24)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_read_reduce(at, block_rows=24)
    for bad in (dict(repeats=0), dict(a=at[0])):
        with pytest.raises(ValueError):
            tk.hbm_read_reduce(**{"a": at, **bad})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale,block_rows,repeats", [(3.0, 8, 2), (1.0, 32, 1), (0.1, 16, 3)])
def test_copy_matches_jax(dtype, scale, block_rows, repeats):
    aj, at = _array((32, 256), dtype, seed=1)
    want = float(jk.hbm_copy(aj, scale=scale, block_rows=block_rows, repeats=repeats,
                             interpret=True))
    out = torch.empty_like(at)
    got = tk.hbm_copy(at, scale=scale, block_rows=block_rows, repeats=repeats, out=out)
    assert got.dtype == torch.float32
    # the copy itself: a times scale rounded to f32, then to a's dtype, as JAX casts it
    s = jnp.asarray(jnp.asarray(scale, jnp.float32), aj.dtype)
    np.testing.assert_array_equal(out.to(torch.float32).numpy(),
                                  np.asarray((aj * s).astype(jnp.float32)))
    tol = RTOL * abs(scale) * (_abs_sum(at[0, :128]) + _abs_sum(at[-1, -128:]))
    assert abs(float(got) - want) <= tol


def test_copy_refuses_what_jax_refuses():
    aj, at = _array((32, 256), "float32", seed=1)
    with pytest.raises(ValueError):
        jk.hbm_copy(aj, block_rows=7, interpret=True)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_copy(at, block_rows=7)
    with pytest.raises(ValueError, match="out must be"):
        tk.hbm_copy(at, block_rows=8, out=torch.empty(32, 128))


def _dma_closed(a, scale, chunk_rows, repeats):
    """JAX's test_hbm_dma_read_token_and_traffic: 128 scale plus row 0, columns
    0:128, of each chunk of each pass."""
    an = a.to(torch.float64).numpy()
    chunks = an.shape[0] // chunk_rows
    expect = 128 * scale
    for r in range(repeats * chunks):
        expect += an[(r % chunks) * chunk_rows, :128].sum()
    return expect


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk_rows,depth,repeats", [(16, 2, 1), (16, 3, 2), (32, 4, 3),
                                                      (64, 2, 2)])
def test_dma_read_matches_jax(dtype, chunk_rows, depth, repeats):
    aj, at = _array((64, 256), dtype, seed=2)
    want = float(jk.hbm_dma_read(aj, scale=2.0, chunk_rows=chunk_rows, depth=depth,
                                 repeats=repeats, interpret=True))
    got = tk.hbm_dma_read(at, scale=2.0, chunk_rows=chunk_rows, depth=depth, repeats=repeats)
    assert got.dtype == torch.float32
    tol = RTOL * (256 + repeats * _abs_sum(at[::chunk_rows, :128]))
    assert abs(float(got) - want) <= tol
    assert abs(float(got) - _dma_closed(at, 2.0, chunk_rows, repeats)) <= tol


def test_dma_read_clamps_depth_and_refuses_what_jax_refuses():
    aj, at = _array((64, 256), "float32", seed=2)
    with pytest.raises(ValueError):
        jk.hbm_dma_read(aj, chunk_rows=48, interpret=True)
    with pytest.raises(ValueError, match="does not divide"):
        tk.hbm_dma_read(at, chunk_rows=48)
    # one 64-row chunk, depth 4: clamped to 1 (no copy that is never waited for)
    want = float(jk.hbm_dma_read(aj, scale=0.0, chunk_rows=64, depth=4, repeats=1,
                                 interpret=True))
    got = float(tk.hbm_dma_read(at, scale=0.0, chunk_rows=64, depth=4, repeats=1))
    np.testing.assert_allclose(got, float(at[0, :128].sum()), rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for bad in (dict(depth=0), dict(repeats=0), dict(a=at[:, :64], chunk_rows=16)):
        with pytest.raises(ValueError):
            tk.hbm_dma_read(**{"a": at, **bad})


# -- utils/profiling.py -----------------------------------------------------------


def test_throughput_report_matches_jax_where_the_roof_is_known():
    """The same arithmetic as JAX's; the port's roof is the card's data-sheet
    rate, and NaN (not JAX's 800 GB/s guess) on the CPU or an unknown card."""
    got = tprof.throughput_report(0.5, 100, 1e9, device="cpu")
    want = jprof.throughput_report(0.5, 100, 1e9)
    for k in ("iters_per_sec", "achieved_gbps"):
        assert got[k] == want[k]
    assert got["iters_per_sec"] == 200.0 and got["achieved_gbps"] == 200.0
    assert math.isnan(got["roofline_gbps"]) and math.isnan(got["frac_roofline"])
    assert math.isnan(tprof.chip_bandwidth_gbps("cpu"))
    assert math.isnan(tprof.chip_bandwidth_gbps(torch.device("cpu")))
    assert tprof.HBM_GBPS["NVIDIA H100 80GB HBM3"] == 3350.0
    assert not any(k.startswith("TPU") for k in tprof.HBM_GBPS)


def test_chip_bandwidth_gbps_reads_the_card_name(monkeypatch):
    """Longest prefix of torch.cuda.get_device_name wins; an unknown card is NaN."""
    for name, want in (("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H200 141GB", 4800.0),
                       ("NVIDIA GeForce RTX 4090", float("nan"))):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        got = tprof.chip_bandwidth_gbps("cuda:0")
        assert got == want or (math.isnan(want) and math.isnan(got))
        rep = tprof.throughput_report(1.0, 10, 335e9, device="cuda:0")
        if not math.isnan(want):
            assert rep["frac_roofline"] == pytest.approx(3350.0 / want)


def test_trace_writes_a_trace_file(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.mv(torch.ones(64, 64), torch.ones(64)).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mv" in e.get("name", "") for e in events)
    assert any("mv" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("flush_bytes", [0, 1 << 20])
def test_flushed_ms_refuses_the_cpu(flush_bytes, monkeypatch):
    """flushed_ms times on a card; with none (or none visible) it raises instead of
    timing the CPU, warm (flush_bytes 0) or cold."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tprof.flushed_ms(lambda: None, reps=2, flush_bytes=flush_bytes)
