"""adaprox_tpu_torch: the PyTorch + CUDA port of ``adaprox_tpu``.

The adaptive proximal-gradient family (AdaPGM) for

    minimize_x  f(x) + g(x)

on one NVIDIA H100, with hand-written Hopper kernels where the JAX package
had Pallas TPU kernels. The JAX package stays the reference: module paths
mirror it, and the tests hold each piece to its JAX counterpart on the same
numpy inputs. This package imports torch and numpy, never jax.

Layout:
  ops/         prox functions, smooth oracles, the accumulation policy, K1
  csrc/        CUDA C++ sources of the kernels
  solvers/     stepsize rules, counters/records, the proximal-gradient engine
  models/      objectives and problem generators
  utils/       JSONL telemetry and timing on the card
  experiments/ the lasso driver
  convert.py   the JAX side's problem and rule fields, carried over

Importing the package sets full-f32 matrix products on the card: TF32 off
for matmuls and cuDNN, float32 matmul precision "highest". A reduced-
precision matvec cost 2.6e-3 gradient error against 3.8e-7 on the TPU,
which poisons the adaptive rules' curvature recurrences.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .ops.prox import Zero, L1Norm  # noqa: E402
from .ops.oracles import SmoothOracle  # noqa: E402
from .ops.kernels import fused_ls_value_grad, ls_value_grad_plain  # noqa: E402
from .models.objectives import LeastSquares  # noqa: E402
from .models.synthetic import LassoProblem, random_lasso  # noqa: E402
from .solvers.rules import (  # noqa: E402
    Curvature,
    FixedStepsize,
    MalitskyMishchenkoRule,
    AdaPGMRule,
    OurRule,
)
from .solvers.common import Counters, Records, SolveResult  # noqa: E402
from .solvers.primal_dual import (  # noqa: E402
    adaptive_primal_dual,
    adaptive_proxgrad,
    fixed_proxgrad,
)
from .convert import lasso_from_numpy, rule_from_numpy  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    # ops
    "Zero", "L1Norm", "SmoothOracle", "fused_ls_value_grad", "ls_value_grad_plain",
    # models
    "LeastSquares", "LassoProblem", "random_lasso",
    # rules
    "Curvature", "FixedStepsize", "MalitskyMishchenkoRule", "AdaPGMRule", "OurRule",
    # solvers
    "Counters", "Records", "SolveResult",
    "adaptive_primal_dual", "adaptive_proxgrad", "fixed_proxgrad",
    # carried over from the JAX side
    "lasso_from_numpy", "rule_from_numpy",
]
