"""dcora_tpu: distributed certifiably-correct range-aided SLAM in JAX.

A from-scratch JAX/XLA re-design of the capabilities of adthoms/dcora
(DCORA: Distributed Certifiably Correct Range-Aided SLAM, arXiv:2503.03192):

  * rank-restricted SDP relaxation over a product manifold
    St(d,r)^n x OB(r)^l x R^{r x (n+b)}  (reference: QuadraticProblem.h:30-40)
  * Riemannian staircase with min-eigenvalue certification and saddle escape
  * distributed Riemannian block-coordinate descent (RBCD / RBCD++) across
    agents with separator (public state) exchange
  * GNC robust weighting (TLS), chordal/odometry initialization

Design deltas from the reference (accelerator-first, not a port):
  * state is dense structured arrays, manifold ops are pure batched functions
  * cost is matrix-free: measurement SoA -> gather/einsum/segment-sum, or
    RCM-reordered dense tiles of Q for large problems
  * the full staircase runs at a static allocation rank r_max with row
    masking, so one compiled step serves every staircase level
  * sparse Cholesky (CHOLMOD/SPQR/Spectra) is replaced by block-Jacobi
    preconditioned tCG, CG least-squares, and matrix-free Lanczos
"""

import os

import jax

# Certification and noiseless fixed-point parity require double precision
# (reference test bar: 1e-9, tests/testAgent.cpp:20).
if os.environ.get("DCORA_TPU_X64", "1") == "1":
    jax.config.update("jax_enable_x64", True)
# f32 matmuls must not drop to TF32 (or bf16 passes): the f32 tile SpMM
# feeds tCG directions, and ~3 significant digits there stall the solver.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only without it does the package pick a fixed directory inside
# the checkout (the path is part of the cache key, so it must not move).
if os.environ.get("DCORA_JAX_CACHE", "1") == "1" and \
        not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from dcora_tpu.types import (  # noqa: E402
    AgentParameters,
    BlockSelectionRule,
    GraphType,
    InitializationMethod,
    ROptParameters,
    RobustCostParameters,
    RobustCostType,
    StateType,
)

__version__ = "0.1.0"

__all__ = [
    "AgentParameters",
    "BlockSelectionRule",
    "GraphType",
    "InitializationMethod",
    "ROptParameters",
    "RobustCostParameters",
    "RobustCostType",
    "StateType",
]
