"""K1's plain version in the PyTorch port against the JAX package's Pallas
kernel ``fused_ls_value_grad`` run in interpret mode on the CPU, on the same
numpy inputs. The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py) and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import gaussian, np_of

from adaprox_tpu.ops import kernels as jk
from adaprox_tpu_torch.ops import kernels as tk

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
