"""Manifold operations on the product St(d,r)^n x OB(r)^l x R^{r x (n+b)}.

Pure batched functions replacing the reference's ROPTLIB containers
(LiftedManifold.cpp:18-89) and matrix-form helpers
(DCORA_utils.cpp:1661-1711, 2033-2051):

  * project:          metric projection onto the manifold
  * tangent_project:  V - Y sym(Y^T V) per Stiefel block; oblique column
                      de-projection; identity on Euclidean blocks
  * retract:          polar retraction (second-order) per Stiefel block,
                      column renormalization on the oblique factor

The polar retraction uses an eigendecomposition of the d x d Gram matrix
(d in {2,3}) rather than a tall QR: it is batched and branch-free. Rows of X above the active rank that are zero stay
zero under all of these maps, which is what lets the Riemannian staircase run
at a fixed allocation rank with row masking (design delta vs. reference,
which reinstantiates per rank: MultiRobotExample.cpp:172-217).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dcora_tpu.core.lifted import RAState


def _sym(P):
    return 0.5 * (P + jnp.swapaxes(P, -1, -2))


def _inv_sqrt_psd(G, eps=0.0):
    """Batched inverse matrix square root of small SPD matrices via eigh."""
    w, U = jnp.linalg.eigh(G)
    w = jnp.maximum(w, 1e-300)
    inv_sqrt_w = 1.0 / jnp.sqrt(w)
    return jnp.einsum("...ij,...j,...kj->...ik", U, inv_sqrt_w, U)


def stiefel_project(A: jax.Array) -> jax.Array:
    """Polar factor of A ([..., r, d]): nearest Stiefel point.

    reference: projectToStiefelManifold (DCORA_utils.cpp:1677-1683), computed
    here as A (A^T A)^{-1/2} instead of a thin SVD.
    """
    G = jnp.einsum("...ri,...rj->...ij", A, A)
    return jnp.einsum("...rd,...de->...re", A, _inv_sqrt_psd(G))


def rotation_project(M: jax.Array) -> jax.Array:
    """Nearest SO(d) matrix: SVD with determinant fix.

    reference: projectToRotationGroup (DCORA_utils.cpp:1661-1675).
    M: [..., d, d].
    """
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    # flip the last column of U where det < 0
    d = M.shape[-1]
    flip = jnp.where(det < 0, -1.0, 1.0)
    U = U.at[..., :, d - 1].multiply(flip[..., None])
    return U @ Vt


def oblique_project(S: jax.Array) -> jax.Array:
    """Column-normalize ([l, r] rows here are the sphere vectors).

    reference: projectToObliqueManifold (DCORA_utils.cpp:1685-1693).
    """
    nrm = jnp.linalg.norm(S, axis=-1, keepdims=True)
    return S / jnp.where(nrm == 0, 1.0, nrm)


def project(X: RAState) -> RAState:
    """Metric projection of an arbitrary ambient point onto the manifold."""
    return RAState(
        rot=stiefel_project(X.rot), sph=oblique_project(X.sph), trn=X.trn
    )


def tangent_project(X: RAState, V: RAState) -> RAState:
    """Project ambient V onto the tangent space at X.

    Stiefel: V_i - Y_i sym(Y_i^T V_i)  (reference: DCORA_utils.cpp:2033-2043,
    symBlockDiagProduct DCORA_utils.cpp:1695-1711).
    Oblique: V_q - s_q <s_q, V_q>     (reference: DCORA_utils.cpp:2045-2051).
    Euclidean: identity.
    """
    P = jnp.einsum("nri,nrj->nij", X.rot, V.rot)
    rot = V.rot - jnp.einsum("nrd,nde->nre", X.rot, _sym(P))
    inner = jnp.sum(X.sph * V.sph, axis=-1, keepdims=True)
    sph = V.sph - X.sph * inner
    return RAState(rot=rot, sph=sph, trn=V.trn)


def retract(X: RAState, V: RAState) -> RAState:
    """Retraction: polar on Stiefel blocks, normalize on oblique, add on R."""
    return RAState(
        rot=stiefel_project(X.rot + V.rot),
        sph=oblique_project(X.sph + V.sph),
        trn=X.trn + V.trn,
    )


# --- random / fixed generators ---------------------------------------------


def random_stiefel(key, n: int, r: int, d: int) -> jax.Array:
    """n random Stiefel blocks [n, r, d] (uniform via polar of Gaussian)."""
    A = jax.random.normal(key, (n, r, d), dtype=jnp.float64)
    return stiefel_project(A)


def random_oblique(key, l: int, r: int) -> jax.Array:  # noqa: E741
    S = jax.random.normal(key, (l, r), dtype=jnp.float64)
    return oblique_project(S)


def random_state(key, dims, r: int) -> RAState:
    k1, k2, k3 = jax.random.split(key, 3)
    return RAState(
        rot=random_stiefel(k1, dims.n, r, dims.d),
        sph=random_oblique(k2, dims.l, r),
        trn=jax.random.normal(k3, (dims.num_trans, r), dtype=jnp.float64),
    )


def fixed_lifting_matrix(r: int, d: int, seed: int = 1) -> jax.Array:
    """Deterministic Stiefel matrix [r, d] shared by all agents.

    Replaces fixedStiefelVariable (DCORA_utils.cpp:2053-2057, srand(1)); here
    determinism comes from a fixed jax PRNG seed.
    """
    key = jax.random.PRNGKey(seed)
    return random_stiefel(key, 1, r, d)[0]


# --- feasibility checks (host/test helpers) ---------------------------------


def stiefel_error(Y: jax.Array) -> jax.Array:
    d = Y.shape[-1]
    G = jnp.einsum("...ri,...rj->...ij", Y, Y)
    return jnp.max(jnp.abs(G - jnp.eye(d, dtype=Y.dtype)))


def oblique_error(S: jax.Array) -> jax.Array:
    if S.shape[0] == 0:
        return jnp.zeros(())
    return jnp.max(jnp.abs(jnp.linalg.norm(S, axis=-1) - 1.0))


def manifold_error(X: RAState) -> jax.Array:
    return jnp.maximum(stiefel_error(X.rot), oblique_error(X.sph))
