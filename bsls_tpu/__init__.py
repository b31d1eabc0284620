"""bsls_tpu — block-simplex-constrained least squares on JAX accelerators.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
``megacell/block-simplex-least-squares`` reference: projected gradient,
accelerated PGD, projected L-BFGS, entropic mirror descent, and Frank-Wolfe
(+pairwise) solvers over products of simplices, with a fused per-block
projection kernel for NVIDIA GPUs and multi-device mesh sharding.
See SURVEY.md for the blueprint and provenance notes.
"""
from .models import (
    BlockPartition,
    DenseMatrix,
    EllMatrix,
    OracleResult,
    Problem,
    oracle_solve,
    oracle_solve_eq,
    synthetic,
)
from .solvers import SolveResult, solve, solve_equality_constrained
from .parallel import make_mesh
from .serving import Endpoint

__version__ = "0.1.0"
