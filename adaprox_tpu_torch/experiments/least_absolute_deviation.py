"""Least-absolute-deviation experiment (counterpart of
``adaprox_tpu/experiments/least_absolute_deviation.py``; reference
experiments/least_absolute_deviation/runme.jl): the square-root lasso's driver
with h = Translate(NormL1, -y), i.e. ||A x - y||_1 (runme.jl:40-42).

    python -m adaprox_tpu_torch.experiments.least_absolute_deviation \
        [--resident | --resident-grid | --fused]
"""

from .square_root_lasso import main as _main


def main(argv=None):
    return _main(argv, inner="l1", default_outdir="results/least_absolute_deviation")


if __name__ == "__main__":
    main()
