"""The accumulation-dtype policy, single-sourced (counterpart of
``adaprox_tpu/ops/linops.py::acc_dtype``)."""

from __future__ import annotations

import torch

__all__ = ["acc_dtype"]


def acc_dtype(a, v):
    """Accumulate in the iterate/vector dtype when ``a`` is stored bf16 (f32
    accumulation for bf16 matrices), otherwise in the promoted type."""
    if a.dtype == torch.bfloat16:
        return v.dtype
    return torch.promote_types(a.dtype, v.dtype)
