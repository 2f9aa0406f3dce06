"""adaprox_tpu_torch: the PyTorch + CUDA port of ``adaprox_tpu``.

The adaptive proximal-gradient family (AdaPGM) and the adaptive
primal-dual method (AdaPDM) for

    minimize_x  f(x) + g(x) + h(Ax)

on one NVIDIA H100, with hand-written Hopper kernels where the JAX package
had Pallas TPU kernels. The JAX package stays the reference: module paths
mirror it, and the tests hold each piece to its JAX counterpart on the same
numpy inputs. This package imports torch and numpy, never jax.

Layout:
  ops/         prox functions (the norms, indicators, Translate) and
               conjugates, smooth oracles (ZeroSmooth among them), the dense
               operator and the accumulation policy, the fused oracles K1
               (least squares) and K3 (logistic), the whole-solve kernels K2
               (one solve) and K2c (the rule sweep), the backtracking
               whole-solve kernels K4 and K4b (its sweep), K4's aGRAAL kernel,
               the dual-SVM primal-dual kernels K6a, K6b (the t-sweep) and
               K6d (Condat-Vu), K6c (the Malitsky-Pock t-sweep), and the f = 0
               family's (square-root lasso, least absolute deviation): K7d
               (Condat-Vu), K7a (the MP and AdaPDM+ t-sweeps), K7b (their
               dataset x t grids) and K7c (Condat-Vu over the datasets), and K5,
               the fused one-pass primal-dual update; ElasticNet, PadTail and
               PadDomain for its solver's menu and auto-pad; the sparse operators
               ELLOperator (K8, the padded-row gather matvec) and BCSROperator
               (K9a and K9b, the block-sparse matvecs), and opnorm2; K2b (B
               independent whole solves in one launch) and the stream probes
               K10a-c (read, copy, bulk-copy read)
  csrc/        CUDA C++ sources of the kernels
  solvers/     stepsize rules, counters/records, the primal-dual engine (its
               proximal-gradient case and Condat-Vu), fixed-step Nesterov,
               backtracking PG and Nesterov, aGRAAL, Malitsky-Pock, AdaPDM+, the
               primal-dual engine on K5 (AdaPDM and Condat-Vu), and batched solves
               (batch_solve, regularization_path)
  models/      objectives (least squares, logistic, the quadratic and its
               factored form, the cubic model, the worst-case quadratic) and
               problem generators
  utils/       JSONL telemetry, timing, tracing and throughput on the card,
               the LIBSVM loader, the datasets (with their synthetic fallback)
               and a numpy copy of JAX's normal draw
  experiments/ the lasso, sparse logistic regression, cubic-regularized
               logistic, Nesterov worst-case, dual SVM, square-root lasso and
               least-absolute-deviation drivers
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

from .ops.prox import (  # noqa: E402
    ElasticNet,
    IndBall2,
    IndBox,
    IndZero,
    L1Norm,
    L2Norm,
    MoreauConjugate,
    PadTail,
    Translate,
    Zero,
    conjugate,
)
from .ops.linops import DenseOperator, frobenius_norm, opnorm2  # noqa: E402
from .ops.sparse import ELLOperator  # noqa: E402
from .ops.bcsr import BCSROperator  # noqa: E402
from .ops.oracles import PadDomain, SmoothOracle, ZeroSmooth  # noqa: E402
from .ops.pd_kernels import fused_pd_primal_update, pd_primal_update_plain  # noqa: E402
from .ops.kernels import (  # noqa: E402
    fused_logistic_value_grad,
    fused_ls_value_grad,
    logistic_value_grad_plain,
    ls_value_grad_plain,
)
from .ops.resident_bt import (  # noqa: E402
    resident_agraal,
    resident_agraal_records,
    resident_backtracking,
    resident_bt_records,
    resident_bt_sweep,
)
from .ops.resident_pd import (  # noqa: E402
    resident_adapdm_dsvm,
    resident_adapdm_dsvm_sweep,
    resident_cv_dsvm,
    resident_cv_records,
    resident_pd_records,
)
from .ops.resident_mp import resident_mp_dsvm_sweep, resident_mp_records  # noqa: E402
from .ops.resident_f0 import (  # noqa: E402
    resident_adapdmp_grid,
    resident_adapdmp_records,
    resident_adapdmp_sweep,
    resident_condat_vu,
    resident_cv_grid,
    resident_mpls_grid,
    resident_mpls_sweep,
)
from .ops.resident import (  # noqa: E402
    resident_adapgm,
    resident_adapgm_batch,
    resident_adapgm_l1,
    resident_logreg_l1,
    resident_records,
    resident_rule_sweep,
    resident_supported,
    rule_rows,
)
from .models.objectives import (  # noqa: E402
    Cubic,
    FactoredQuadratic,
    LeastSquares,
    LogisticLoss,
    Quadratic,
    WorstQuadratic,
)
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
    condat_vu,
    condat_vu_steps,
    fixed_proxgrad,
)
from .solvers.nesterov import fixed_nesterov  # noqa: E402
from .solvers.backtracking import backtracking_nesterov, backtracking_proxgrad  # noqa: E402
from .solvers.agraal import agraal  # noqa: E402
from .solvers.malitsky_pock import malitsky_pock  # noqa: E402
from .solvers.adapdm_plus import adaptive_linesearch_primal_dual  # noqa: E402
from .solvers.pd_fused import fused_adaptive_primal_dual, fused_condat_vu  # noqa: E402
from .convert import (  # noqa: E402
    bcsr_from_numpy,
    cubic_from_numpy,
    dsvm_from_numpy,
    ell_from_numpy,
    factored_from_numpy,
    lasso_from_numpy,
    logreg_from_numpy,
    quadratic_from_numpy,
    rule_from_numpy,
    sqrt_lasso_from_numpy,
    worst_from_numpy,
)

__version__ = "0.1.0"

__all__ = [
    # ops
    "Zero", "L1Norm", "L2Norm", "ElasticNet", "IndZero", "IndBox", "IndBall2", "Translate",
    "PadTail", "MoreauConjugate", "conjugate", "DenseOperator", "frobenius_norm", "opnorm2",
    "ELLOperator", "BCSROperator", "SmoothOracle",
    "ZeroSmooth", "PadDomain", "fused_pd_primal_update", "pd_primal_update_plain",
    "fused_ls_value_grad", "ls_value_grad_plain",
    "fused_logistic_value_grad", "logistic_value_grad_plain",
    "resident_adapgm", "resident_adapgm_batch", "resident_adapgm_l1", "resident_logreg_l1",
    "resident_records",
    "resident_rule_sweep", "resident_supported", "rule_rows", "resident_backtracking",
    "resident_bt_sweep", "resident_bt_records", "resident_agraal", "resident_agraal_records",
    "resident_adapdm_dsvm", "resident_adapdm_dsvm_sweep", "resident_cv_dsvm",
    "resident_pd_records", "resident_cv_records", "resident_mp_dsvm_sweep", "resident_mp_records",
    "resident_condat_vu", "resident_mpls_sweep", "resident_adapdmp_sweep",
    "resident_adapdmp_records", "resident_mpls_grid", "resident_adapdmp_grid",
    "resident_cv_grid",
    # models
    "LeastSquares", "LogisticLoss", "Quadratic", "FactoredQuadratic", "Cubic", "WorstQuadratic", "LassoProblem", "random_lasso",
    # rules
    "Curvature", "FixedStepsize", "MalitskyMishchenkoRule", "AdaPGMRule", "OurRule",
    # solvers
    "Counters", "Records", "SolveResult",
    "adaptive_primal_dual", "adaptive_proxgrad", "fixed_proxgrad", "condat_vu",
    "condat_vu_steps", "fixed_nesterov",
    "backtracking_proxgrad", "backtracking_nesterov", "agraal", "malitsky_pock",
    "adaptive_linesearch_primal_dual", "fused_adaptive_primal_dual", "fused_condat_vu",
    # carried over from the JAX side
    "lasso_from_numpy", "logreg_from_numpy", "cubic_from_numpy", "worst_from_numpy",
    "quadratic_from_numpy", "factored_from_numpy", "dsvm_from_numpy", "sqrt_lasso_from_numpy",
    "rule_from_numpy", "ell_from_numpy", "bcsr_from_numpy",
]
