"""The experiments' datasets (counterpart of ``adaprox_tpu/utils/datasets.py``;
reference experiments/download_datasets.jl:1-49), numpy only.

The 8 LIBSVM datasets of the reference experiments are read from a local
directory when a file is there. This package downloads nothing: where a file
is missing the drivers fall back to ``synthetic_classification`` /
``synthetic_regression`` generators shaped like the real datasets and seeded
from the name (crc32), bit-identical to the JAX package's fallback, so the
experiment grid stays runnable end to end.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

__all__ = ["DATASET_URLS", "DATASET_SHAPES", "default_dataset_dir", "dataset_path",
           "synthetic_classification", "synthetic_regression", "load_or_synthesize"]

_BASE = "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets"

# where each file comes from; its local name is the URL's last component
DATASET_URLS = {
    "a5a": f"{_BASE}/binary/a5a",
    "mushrooms": f"{_BASE}/binary/mushrooms",
    "phishing": f"{_BASE}/binary/phishing",
    "heart_scale": f"{_BASE}/binary/heart_scale",
    "svmguide3": f"{_BASE}/binary/svmguide3",
    "abalone": f"{_BASE}/regression/abalone",
    "cpusmall_scale": f"{_BASE}/regression/cpusmall_scale",
    "housing_scale": f"{_BASE}/regression/housing_scale",
}

# (rows, features, classification?) of the real datasets: the synthetic
# fallbacks mimic these so oracle-call trajectories are comparable in scale
DATASET_SHAPES = {
    "a5a": (6414, 123, True),
    "mushrooms": (8124, 112, True),
    "phishing": (11055, 68, True),
    "heart_scale": (270, 13, True),
    "svmguide3": (1243, 21, True),
    "abalone": (4177, 8, False),
    "cpusmall_scale": (8192, 12, False),
    "housing_scale": (506, 13, False),
}


def default_dataset_dir():
    return os.environ.get(
        "ADAPROX_DATASETS",
        os.path.join(os.path.dirname(__file__), "..", "..", "datasets"),
    )


def dataset_path(name: str, local_dir: str | None = None) -> str:
    """The local file of dataset ``name``. Raises FileNotFoundError when it
    is not there."""
    local_dir = local_dir or default_dataset_dir()
    path = os.path.join(local_dir, os.path.basename(DATASET_URLS[name]))
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def synthetic_classification(m, n, seed=0, dtype=np.float64):
    """Separable-ish sparse-feature binary problem with {0,1} labels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(dtype)
    x *= (rng.random((m, n)) < 0.3)  # sparsity like the LIBSVM sets
    w = rng.standard_normal(n).astype(dtype)
    logits = x @ w + 0.5 * rng.standard_normal(m)
    y = (logits > 0).astype(dtype)
    return x, y


def synthetic_regression(m, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(dtype)
    w = rng.standard_normal(n).astype(dtype) * (rng.random(n) < 0.5)
    y = x @ w + 0.1 * rng.standard_normal(m)
    return x, y.astype(dtype)


def load_or_synthesize(name: str, dtype=np.float64, labels=None, local_dir=None):
    """Real dataset if its file is present, else a shape-matched synthetic.

    Returns ``(X, y, source)`` with source in {"libsvm", "synthetic"}.
    """
    from .libsvm import load_libsvm_dataset

    m, n, classify = DATASET_SHAPES[name]
    try:
        x, y = load_libsvm_dataset(dataset_path(name, local_dir), dtype=dtype, labels=labels)
        return x, y, "libsvm"
    except Exception as e:
        # a missing file is the expected case; a parse error on a file that
        # exists would otherwise force synthetic data silently: say why
        if not isinstance(e, (FileNotFoundError, OSError)):
            print(f"  [datasets] {name}: real-data load failed "
                  f"({type(e).__name__}: {str(e)[:120]}); using synthetic")
        # a stable cross-process seed (Python's str hash is salted per process)
        seed = zlib.crc32(name.encode()) % 2**31
        if classify:
            x, y = synthetic_classification(m, n, seed=seed, dtype=dtype)
            if labels is not None:
                l0, l1 = labels
                y = np.where(y > 0.5, l1, l0).astype(dtype)
        else:
            x, y = synthetic_regression(m, n, seed=seed, dtype=dtype)
        return x, y, "synthetic"
