"""Trajectory initialization: odometry chaining and chordal relaxation.

Chordal initialization (reference: DCORA_solver.cpp:218-268, B matrices
DCORA_utils.cpp:1542-1659, eq. (69) of the SE-Sync tech report) solves two
sparse least-squares problems. The reference uses SuiteSparse SPQR; here we
solve the (graph-Laplacian) normal equations matrix-free with Jacobi-
preconditioned CG:

  rotations:    min_R sum_e kappa_e ||R_j - R_i R_e||_F^2,  R_0 = I
  translations: min_t sum_e tau_e   ||t_j - t_i - R_i t_e||^2,  t_0 = 0

Both systems are SPD on the subspace with pose 0 pinned; CG on them is exact
in the limit and converges fast thanks to the degree preconditioner.
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from dcora_tpu.core.manifold import rotation_project
from dcora_tpu.measurements import RelativePosePoseMeasurement


def odometry_initialization(odometry: List[RelativePosePoseMeasurement],
                            partial_trajectory: np.ndarray | None = None
                            ) -> np.ndarray:
    """Chain odometry into a trajectory [n, d, d+1].

    reference: DCORA_solver.cpp:270-302. odometry[k] must connect k -> k+1.
    """
    assert odometry, "empty odometry"
    d = odometry[0].t.shape[0]
    n = max(max(m.p1, m.p2) for m in odometry) + 1
    T = np.zeros((n, d, d + 1))
    next_index = 0
    if partial_trajectory is not None and len(partial_trajectory) > 0:
        m = min(len(partial_trajectory), n)
        T[:m] = partial_trajectory[:m]
        next_index = m
    else:
        T[0, :, :d] = np.eye(d)
        next_index = 1
    odo = {m.p1: m for m in odometry}
    for dst in range(next_index, n):
        m = odo[dst - 1]
        assert m.p1 == dst - 1 and m.p2 == dst
        R_src = T[dst - 1, :, :d]
        T[dst, :, :d] = R_src @ m.R
        T[dst, :, d] = T[dst - 1, :, d] + R_src @ m.t
    return T


@partial(jax.jit, static_argnames=("n",))
def _chordal_rotations(ii, jj, Rm, kappa, n: int):
    """Solve the pinned rotation Laplacian system with Jacobi-PCG.

    Unknown X: [n, d, d] (free d x d matrices). Operator:
      (L X)_i = sum_{e=(i,j)} k (X_i - X_j R_e^T) + sum_{e=(j,i)} k (X_j - X_i R_e)
    with row 0 masked (R_0 = I pinned).
    """
    d = Rm.shape[1]

    def lap(X):
        Xi = X[ii]
        Xj = X[jj]
        c_i = kappa[:, None, None] * (
            Xi - jnp.einsum("mre,mde->mrd", Xj, Rm)
        )
        c_j = kappa[:, None, None] * (
            Xj - jnp.einsum("mre,med->mrd", Xi, Rm)
        )
        return jax.ops.segment_sum(
            jnp.concatenate([c_i, c_j]), jnp.concatenate([ii, jj]), n
        )

    mask = (jnp.arange(n) > 0)[:, None, None]

    def A(x):
        return jnp.where(mask, lap(jnp.where(mask, x, 0.0)), 0.0)

    X0 = jnp.zeros((n, d, d)).at[0].set(jnp.eye(d))
    b = jnp.where(mask, -lap(X0), 0.0)

    deg = jax.ops.segment_sum(
        jnp.concatenate([kappa, kappa]), jnp.concatenate([ii, jj]), n
    )
    deg = jnp.where(deg == 0, 1.0, deg)[:, None, None]

    x, _ = jax.scipy.sparse.linalg.cg(
        A, b, M=lambda v: v / deg, tol=1e-12, maxiter=20 * n
    )
    return X0 + x


@partial(jax.jit, static_argnames=("n",))
def _recover_translations(ii, jj, tm, tau, R, n: int):
    """Solve the pinned translation Laplacian (reference:
    recoverTranslations, DCORA_utils.cpp:1633-1659)."""

    def lap(t):
        diff = tau[:, None] * (t[ii] - t[jj])
        return jax.ops.segment_sum(
            jnp.concatenate([diff, -diff]), jnp.concatenate([ii, jj]), n
        )

    mask = (jnp.arange(n) > 0)[:, None]

    def A(x):
        return jnp.where(mask, lap(jnp.where(mask, x, 0.0)), 0.0)

    Rt = jnp.einsum("mde,me->md", R[ii], tm)  # R_i t_e
    rhs = jax.ops.segment_sum(
        jnp.concatenate([-tau[:, None] * Rt, tau[:, None] * Rt]),
        jnp.concatenate([ii, jj]),
        n,
    )
    b = jnp.where(mask, rhs, 0.0)

    deg = jax.ops.segment_sum(
        jnp.concatenate([tau, tau]), jnp.concatenate([ii, jj]), n
    )
    deg = jnp.where(deg == 0, 1.0, deg)[:, None]

    t, _ = jax.scipy.sparse.linalg.cg(
        A, b, M=lambda v: v / deg, tol=1e-12, maxiter=20 * n
    )
    return t


def chordal_initialization(
    measurements: List[RelativePosePoseMeasurement],
) -> np.ndarray:
    """Chordal initialization -> [n, d, d+1] (reference:
    DCORA_solver.cpp:218-268)."""
    assert measurements
    d = measurements[0].t.shape[0]
    n = max(max(m.p1, m.p2) for m in measurements) + 1
    ii = jnp.asarray([m.p1 for m in measurements], dtype=jnp.int32)
    jj = jnp.asarray([m.p2 for m in measurements], dtype=jnp.int32)
    Rm = jnp.asarray(np.stack([m.R for m in measurements]))
    tm = jnp.asarray(np.stack([m.t for m in measurements]))
    kappa = jnp.asarray([m.kappa * m.weight for m in measurements])
    tau = jnp.asarray([m.tau * m.weight for m in measurements])

    X = _chordal_rotations(ii, jj, Rm, kappa, n)
    R = rotation_project(X)
    t = _recover_translations(ii, jj, tm, tau, R, n)

    T = np.zeros((n, d, d + 1))
    T[:, :, :d] = np.asarray(R)
    T[:, :, d] = np.asarray(t)
    return T
