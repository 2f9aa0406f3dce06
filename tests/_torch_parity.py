"""Shared inputs for the parity tests of the PyTorch port (not collected).

Inputs are made once with ``np.random.default_rng(seed)`` and handed to both
packages as numpy arrays, so the JAX package and the port compute from the
same bits. Torch runs one thread per test worker.
"""

import functools

import numpy as np
import torch

torch.set_num_threads(1)


def gaussian(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


@functools.lru_cache(maxsize=None)
def lasso_case(m=100, n=300, pfactor=10, seed=0):
    """``random_lasso(m, n, pfactor)`` zero-padded to the JAX package's
    (8, 128) tiles, as the drivers pad it under ``--fused``. Returns
    ``(a, b, lam, optimum, gamma0)`` with ``gamma0 = 1 / ||A||_2^2``."""
    from adaprox_tpu_torch.models.synthetic import random_lasso

    prob = random_lasso(m=m, n=n, pfactor=pfactor, seed=seed)
    mp, np_ = -(-m // 8) * 8, -(-n // 128) * 128
    a = np.zeros((mp, np_))
    a[:m, :n] = prob.a
    b = np.zeros(mp)
    b[:m] = prob.b
    gamma0 = 1.0 / float(np.linalg.norm(prob.a, 2) ** 2)
    return a, b, prob.lam, prob.optimum, gamma0


def np_of(v):
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
