"""Lifted state container and layout helpers.

The canonical internal layout is the RA ordering (reference: Elements.h:178-183,
Graph.cpp:824-1188):

    X = [ Y_1 .. Y_n | s_1 .. s_l | p_1 .. p_n | L_1 .. L_b ]  in R^{r x k},
    k = d*n + l + n + b

stored as three structured arrays for device-friendly gathers:

    rot: [n, r, d]    lifted rotation (Stiefel) blocks
    sph: [l, r]       unit-sphere columns
    trn: [n+b, r]     pose translations followed by landmark translations

PGO/SE problems are RA problems with l = b = 0; the reference's interleaved SE
layout [Y_1 p_1 .. Y_n p_n] (Elements.h:178) exists only at I/O parity
boundaries via :func:`to_se_matrix` / :func:`from_se_matrix`.

The cost is invariant under this column permutation, so all numerics match the
reference up to ordering.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dcora_tpu.types import ProblemDims


class RAState(NamedTuple):
    """Lifted RA-SLAM state (a jax pytree)."""

    rot: jax.Array  # [n, r, d]
    sph: jax.Array  # [l, r]
    trn: jax.Array  # [n+b, r]

    @property
    def r(self) -> int:
        return self.rot.shape[1]

    @property
    def d(self) -> int:
        return self.rot.shape[2]

    @property
    def n(self) -> int:
        return self.rot.shape[0]

    @property
    def l(self) -> int:  # noqa: E743
        return self.sph.shape[0]

    @property
    def b(self) -> int:
        return self.trn.shape[0] - self.rot.shape[0]

    @property
    def dims(self) -> ProblemDims:
        return ProblemDims(self.d, self.n, self.l, self.b)

    # -- algebra (pytree-wide) ---------------------------------------------
    def __add__(self, other: "RAState") -> "RAState":
        return jax.tree.map(jnp.add, self, other)

    def __sub__(self, other: "RAState") -> "RAState":
        return jax.tree.map(jnp.subtract, self, other)

    def scale(self, a) -> "RAState":
        return jax.tree.map(lambda x: a * x, self)

    def vdot(self, other: "RAState"):
        return sum(
            jnp.vdot(x, y)
            for x, y in zip(jax.tree.leaves(self), jax.tree.leaves(other))
        )

    def norm(self):
        return jnp.sqrt(self.vdot(self))

    # -- accessors ----------------------------------------------------------
    def pose(self, i) -> jax.Array:
        """Lifted pose i as [r, d+1] = [Y_i | p_i]."""
        return jnp.concatenate([self.rot[i], self.trn[i][:, None]], axis=1)

    def landmark(self, j) -> jax.Array:
        return self.trn[self.n + j]

    def unit_sphere(self, q) -> jax.Array:
        return self.sph[q]


def zeros(dims: ProblemDims, r: int, dtype=jnp.float64) -> RAState:
    return RAState(
        rot=jnp.zeros((dims.n, r, dims.d), dtype),
        sph=jnp.zeros((dims.l, r), dtype),
        trn=jnp.zeros((dims.num_trans, r), dtype),
    )


def to_flat(X: RAState) -> jax.Array:
    """RAState -> dense [r, k] in RA column ordering."""
    r = X.r
    rot_flat = jnp.transpose(X.rot, (1, 0, 2)).reshape(r, -1)  # [r, d*n]
    return jnp.concatenate([rot_flat, X.sph.T, X.trn.T], axis=1)


def from_flat(M: jax.Array, dims: ProblemDims) -> RAState:
    """Dense [r, k] in RA ordering -> RAState."""
    r = M.shape[0]
    assert M.shape[1] == dims.k, (M.shape, dims)
    d, n, l = dims.d, dims.n, dims.l
    rot = jnp.transpose(M[:, : d * n].reshape(r, n, d), (1, 0, 2))
    sph = M[:, d * n : d * n + l].T
    trn = M[:, d * n + l :].T
    return RAState(rot=rot, sph=sph, trn=trn)


def to_se_matrix(X: RAState) -> jax.Array:
    """RAState -> reference SE interleaved layout [r, (d+1)n], poses only."""
    # [n, r, d+1] -> [r, n*(d+1)]
    blocks = jnp.concatenate([X.rot, X.trn[: X.n, :, None]], axis=2)
    return jnp.transpose(blocks, (1, 0, 2)).reshape(X.r, -1)


def from_se_matrix(M, d: int) -> RAState:
    """Reference SE interleaved layout [r, (d+1)n] -> RAState (l=b=0)."""
    M = jnp.asarray(M)
    r = M.shape[0]
    n = M.shape[1] // (d + 1)
    blocks = jnp.transpose(M.reshape(r, n, d + 1), (1, 0, 2))  # [n, r, d+1]
    return RAState(
        rot=blocks[:, :, :d],
        sph=jnp.zeros((0, r), M.dtype),
        trn=blocks[:, :, d],
    )


def from_pose_array(T: np.ndarray, l: int = 0, b: int = 0,  # noqa: E741
                    landmarks: np.ndarray | None = None,
                    spheres: np.ndarray | None = None) -> RAState:
    """Rank-d state from host pose array T: [n, d, d+1] (+optional extras).

    landmarks: [b, d]; spheres: [l, d]. Missing extras are zero.
    """
    T = np.asarray(T)
    n, d = T.shape[0], T.shape[1]
    # T[:, :, :d] is R_i (d x d); at r = d the lifted rotation block Y_i = R_i.
    rot = jnp.asarray(T[:, :, :d])
    trn_pose = T[:, :, d]  # [n, d]
    trn = np.zeros((n + b, d))
    trn[:n] = trn_pose
    if landmarks is not None and b:
        trn[n:] = landmarks
    sph = np.zeros((l, d))
    if spheres is not None and l:
        sph[:] = spheres
    return RAState(rot=rot, sph=jnp.asarray(sph), trn=jnp.asarray(trn))


def lift(X: RAState, Y_lift: jax.Array) -> RAState:
    """Lift a rank-d state to rank r via X_lifted = Y_lift @ X.

    Y_lift: [r, d] fixed Stiefel lifting matrix (reference: Agent.cpp:49-50,
    512-517). In our block layout each column block is left-multiplied.
    """
    return RAState(
        rot=jnp.einsum("rd,nde->nre", Y_lift, X.rot),
        sph=jnp.einsum("rd,ld->lr", Y_lift, X.sph),
        trn=jnp.einsum("rd,td->tr", Y_lift, X.trn),
    )


def pad_rank(X: RAState, r_new: int) -> RAState:
    """Zero-pad the rank (row) dimension to r_new."""
    pad = r_new - X.r
    assert pad >= 0
    return RAState(
        rot=jnp.pad(X.rot, ((0, 0), (0, pad), (0, 0))),
        sph=jnp.pad(X.sph, ((0, 0), (0, pad))),
        trn=jnp.pad(X.trn, ((0, 0), (0, pad))),
    )


def truncate_rank(X: RAState, r_new: int) -> RAState:
    return RAState(
        rot=X.rot[:, :r_new, :], sph=X.sph[:, :r_new], trn=X.trn[:, :r_new]
    )


# --- host-side SE(d) helpers ------------------------------------------------


def pose_identity(d: int) -> np.ndarray:
    T = np.zeros((d, d + 1))
    T[:, :d] = np.eye(d)
    return T


def pose_inverse(T: np.ndarray) -> np.ndarray:
    d = T.shape[0]
    out = np.zeros_like(T)
    out[:, :d] = T[:, :d].T
    out[:, d] = -T[:, :d].T @ T[:, d]
    return out


def pose_multiply(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    d = A.shape[0]
    out = np.zeros_like(A)
    out[:, :d] = A[:, :d] @ B[:, :d]
    out[:, d] = A[:, :d] @ B[:, d] + A[:, d]
    return out
