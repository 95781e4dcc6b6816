"""Optimality certification: dual certificate, Lanczos min-eig, saddle escape.

Replaces the reference's CHOLMOD PSD check + Spectra eigensolvers
(DCORA_utils.cpp:1713-1982) with a matrix-free Lanczos (full
reorthogonalization) over the S = Q - Lambda(X) operator, following the
SE-Sync v1.0 spectrum-shifting strategy the reference adopts
(DCORA_utils.cpp:1807-1896):

  1. lambda_lm <- largest-magnitude eigenvalue of S. If negative, it IS the
     minimum eigenvalue: return it.
  2. Otherwise run Lanczos on C = S - 2*lambda_lm*I (all eigenvalues
     negative); its largest-magnitude eigenvalue + 2*lambda_lm is
     lambda_min(S).

Also implements the saddle-escape backtracking line search
(QuadraticProblem.cpp:138-234, SE-Sync / Algorithm 7 of the DC2-PGO report)
and the rank-d solution rounding (CORA Alg. 3, DCORA_utils.cpp:1984-2031).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dcora_tpu.core import lifted, problem as prob
from dcora_tpu.core.lifted import RAState
from dcora_tpu.core.manifold import (
    oblique_project,
    retract,
    rotation_project,
    tangent_project,
)
from dcora_tpu.core.problem import ProblemData
from dcora_tpu.types import ProblemDims


class Certificate(NamedTuple):
    """Lambda(X) blocks of the dual certificate S = Q - Lambda."""

    rot_blocks: jax.Array  # [n, d, d] symmetric Stiefel multipliers
    sph_diag: jax.Array  # [l] oblique multipliers


def dual_certificate_blocks(P: ProblemData, X: RAState) -> Certificate:
    """Lambda blocks (reference: constructDualCertificateMatrixPGO/RASLAM,
    DCORA_utils.cpp:1898-1982). In the RA basis the PGO and RA formulas
    coincide: d x d symmetric blocks on rotations, scalars on spheres."""
    W = prob.apply_Q(P, X)
    Prot = jnp.einsum("nri,nrj->nij", W.rot, X.rot)
    rot_blocks = 0.5 * (Prot + jnp.swapaxes(Prot, 1, 2))
    sph_diag = jnp.sum(X.sph * W.sph, axis=-1)
    return Certificate(rot_blocks=rot_blocks, sph_diag=sph_diag)


def apply_S(P: ProblemData, C: Certificate, V: RAState) -> RAState:
    """V S = V Q - V Lambda."""
    W = prob.apply_Q(P, V)
    return RAState(
        rot=W.rot - jnp.einsum("nrd,nde->nre", V.rot, C.rot_blocks),
        sph=W.sph - V.sph * C.sph_diag[:, None],
        trn=W.trn,
    )


# --------------------------------------------------------------------------
# Matrix-free Lanczos with full reorthogonalization (flat-vector interface).
# --------------------------------------------------------------------------


def _flat_matvec(P: ProblemData, C: Certificate, dims: ProblemDims, shift):
    def mv(v):  # v: [k]
        V = lifted.from_flat(v[None, :], dims)
        W = apply_S(P, C, V)
        return lifted.to_flat(W)[0] + shift * v

    return mv


@partial(jax.jit, static_argnames=("dims", "m"))
def _lanczos_extreme(P: ProblemData, C: Certificate, dims: ProblemDims,
                     shift, v0, m: int):
    """Largest-magnitude Ritz pair of (S + shift*I) after m Lanczos steps.

    Full reorthogonalization keeps the basis numerically orthogonal, which
    is what lets near-zero minimum eigenvalues converge (the failure mode
    the reference works around with its shift-and-invert fallback,
    DCORA_utils.cpp:1749-1805).
    """
    k = dims.k
    mv = _flat_matvec(P, C, dims, shift)

    basis = jnp.zeros((m, k))
    alphas = jnp.zeros((m,))
    betas = jnp.zeros((m,))

    v = v0 / jnp.linalg.norm(v0)

    def body(j, carry):
        basis, alphas, betas, v = carry
        basis = basis.at[j].set(v)
        w = mv(v)
        a = jnp.vdot(v, w)
        alphas = alphas.at[j].set(a)
        # full reorthogonalization (two passes)
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        b = jnp.linalg.norm(w)
        betas = betas.at[j].set(b)
        # lucky breakdown: restart with a deterministic pseudo-random
        # direction orthogonal to the current basis
        fresh = jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(0), j), (k,))
        for _ in range(2):
            fresh = fresh - basis.T @ (basis @ fresh)
        fresh = fresh / jnp.maximum(jnp.linalg.norm(fresh), 1e-300)
        v_next = jnp.where(b > 1e-12, w / jnp.where(b == 0, 1.0, b), fresh)
        return basis, alphas, betas, v_next

    basis, alphas, betas, _ = jax.lax.fori_loop(
        0, m, body, (basis, alphas, betas, v)
    )

    T = (
        jnp.diag(alphas)
        + jnp.diag(betas[:-1], 1)
        + jnp.diag(betas[:-1], -1)
    )
    evals, evecs = jnp.linalg.eigh(T)
    idx = jnp.argmax(jnp.abs(evals))
    theta = evals[idx]
    y = basis.T @ evecs[:, idx]
    resid = jnp.abs(betas[m - 1] * evecs[m - 1, idx])
    return theta, y, resid


def minimum_eigen_pair(P: ProblemData, C: Certificate, dims: ProblemDims,
                       num_lanczos: int = 64,
                       v0: Optional[np.ndarray] = None
                       ) -> Tuple[float, np.ndarray, float]:
    """(lambda_min, eigvec, residual) of S via spectrum shifting."""
    m = min(num_lanczos, dims.k)
    if v0 is None:
        rng = np.random.default_rng(0)
        v0 = rng.standard_normal(dims.k)
    v0 = jnp.asarray(v0)

    lam_lm, y_lm, res_lm = _lanczos_extreme(
        P, C, dims, jnp.zeros(()), v0, m
    )
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, np.asarray(y_lm), float(res_lm)

    # shift: C2 = S - 2 lambda_lm I has all eigenvalues negative; its
    # largest-magnitude eigenvalue is lambda_min(S) - 2 lambda_lm.
    # v0 heuristic: perturbed S e0 row (reference: DCORA_utils.cpp:1861-1866)
    e0 = jnp.zeros(dims.k).at[0].set(1.0)
    row0 = _flat_matvec(P, C, dims, 0.0)(e0)
    rng = np.random.default_rng(1)
    pert = rng.standard_normal(dims.k)
    pert /= np.linalg.norm(pert)
    v0s = row0 + 0.03 * jnp.linalg.norm(row0) * jnp.asarray(pert)
    if float(jnp.linalg.norm(v0s)) < 1e-12:
        v0s = jnp.asarray(rng.standard_normal(dims.k))

    # Restarted Lanczos: one m-step sweep is not enough when the bottom of
    # the spectrum is clustered relative to the spread (the relative gap
    # can be ~1e-6, e.g. single_drone.pyfg, where a single sweep missed a
    # -4.7e-3 eigenvalue and falsely certified).  Each restart seeds the
    # next sweep with the current Ritz vector, so the estimate decreases
    # monotonically; stop after two consecutive stagnant sweeps.
    lam_best, y_best, res_best = None, None, 0.0
    stagnant = 0
    for _ in range(40):
        lam_s, y_s, res_s = _lanczos_extreme(
            P, C, dims, -2.0 * lam_lm, v0s, m
        )
        lam_cur = float(lam_s + 2.0 * lam_lm)
        if lam_best is not None and \
                lam_cur > lam_best - max(1e-12, 1e-9 * abs(lam_lm_f)):
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        # keep (value, vector, residual) as one consistent triple: a sweep
        # that regresses must not overwrite the vector of the best value
        if lam_best is None or lam_cur < lam_best:
            lam_best, y_best, res_best = lam_cur, y_s, res_s
        v0s = jnp.asarray(y_s)
    return lam_best, np.asarray(y_best), float(res_best)


# --------------------------------------------------------------------------
# Flat tiled Lanczos (dense-tile fast path).  The Lambda(X) application has exactly
# the Weingarten-apply form (sym blocks on rotations, scalars on spheres),
# so the S matvec in the flat basis is apply_tiled - weingarten_apply; the
# permutation conjugation preserves the spectrum and from_flat converts the
# eigenvector back.
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("m",))
def _lanczos_extreme_flat(TP, aux, shift, v0, m: int):
    """Largest-magnitude Ritz pair of (S + shift*I), flat tiled matvec."""
    from dcora_tpu.core import tiled

    kpad = v0.shape[0]
    r_pad = 8  # the tiled state's minimum row padding; rows 1.. stay zero

    def mv(v):
        V = jnp.zeros((r_pad, kpad), v.dtype).at[0].set(v)
        W = tiled.apply_tiled(TP, V) - tiled.weingarten_apply(
            TP.meta, V, aux
        )
        return W[0] + shift * v

    basis = jnp.zeros((m, kpad), v0.dtype)
    alphas = jnp.zeros((m,), v0.dtype)
    betas = jnp.zeros((m,), v0.dtype)
    v = v0 / jnp.linalg.norm(v0)

    def body(j, carry):
        basis, alphas, betas, v = carry
        basis = basis.at[j].set(v)
        w = mv(v)
        a = jnp.vdot(v, w)
        alphas = alphas.at[j].set(a)
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        b = jnp.linalg.norm(w)
        betas = betas.at[j].set(b)
        fresh = jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), j), (kpad,),
            dtype=v0.dtype,
        )
        for _ in range(2):
            fresh = fresh - basis.T @ (basis @ fresh)
        fresh = fresh / jnp.maximum(jnp.linalg.norm(fresh), 1e-30)
        v_next = jnp.where(b > 1e-7, w / jnp.where(b == 0, 1.0, b), fresh)
        return basis, alphas, betas, v_next

    basis, alphas, betas, _ = jax.lax.fori_loop(
        0, m, body, (basis, alphas, betas, v)
    )
    T = (
        jnp.diag(alphas)
        + jnp.diag(betas[:-1], 1)
        + jnp.diag(betas[:-1], -1)
    )
    evals, evecs = jnp.linalg.eigh(T)
    idx = jnp.argmax(jnp.abs(evals))
    return evals[idx], basis.T @ evecs[:, idx]


def minimum_eigen_pair_tiled(TP, X: RAState, num_lanczos: int = 64):
    """(lambda_min estimate, RA-flat eigenvector) via the tiled S operator.

    Runs at the tile dtype (f32 on the coarse path); callers must validate
    PSD conclusions at f64 (see fast_verification)."""
    from dcora_tpu.core import tiled

    meta = TP.meta
    dt = TP.Q.tiles.dtype
    r_pad = max(8, -(-X.r // 8) * 8)
    Xf = tiled.to_flat(TP, X, r_pad=r_pad).astype(dt)
    W = tiled.apply_tiled(TP, Xf)
    aux = tiled.weingarten_setup(meta, Xf, W)

    m = min(num_lanczos, meta.k)
    rng = np.random.default_rng(0)
    v0 = np.zeros(meta.kpad)
    v0[:meta.k] = rng.standard_normal(meta.k)
    v0 = jnp.asarray(v0, dt)

    lam_lm, y_lm = _lanczos_extreme_flat(TP, aux, jnp.asarray(0.0, dt),
                                         v0, m)
    if float(lam_lm) < 0:
        y = tiled.from_flat(TP, y_lm[None].astype(jnp.float64))
        return float(lam_lm), np.asarray(lifted.to_flat(y)[0])
    # restarted sweeps (see minimum_eigen_pair: single sweeps miss
    # clustered bottom eigenvalues); f32 here, so stagnate at f32 noise
    lam_best, y_best = None, None
    stagnant = 0
    for _ in range(20):
        lam_s, y_s = _lanczos_extreme_flat(
            TP, aux, jnp.asarray(-2.0, dt) * lam_lm, v0, m
        )
        lam_cur = float(lam_s + 2.0 * float(lam_lm))
        if lam_best is not None and \
                lam_cur > lam_best - 1e-6 * abs(float(lam_lm)):
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        if lam_best is None or lam_cur < lam_best:
            lam_best, y_best = lam_cur, y_s
        v0 = y_s
    y = tiled.from_flat(TP, y_best[None].astype(jnp.float64))
    return lam_best, np.asarray(lifted.to_flat(y)[0])


def _Q_host(P: ProblemData, dims: ProblemDims):
    """Exact scipy CSR of the local Q, reconstructed from the ELL form
    (ELL slots + the COO overflow together carry every entry) or, when P
    carries no ELL, assembled host-side by the same closed-form blocks."""
    import scipy.sparse as sp

    E = P.ell
    if E is None:
        E = prob.build_ell(
            dims.n, dims.l, dims.b, dims.d,
            P.pp_ri, P.pp_rj, P.pp_ti, P.pp_tj, P.pp_R, P.pp_t,
            np.asarray(P.pp_kappa) * np.asarray(P.pp_w)
            * np.asarray(P.pp_active),
            np.asarray(P.pp_tau) * np.asarray(P.pp_w)
            * np.asarray(P.pp_active),
            P.pl_ri, P.pl_ti, P.pl_tj, P.pl_t,
            np.asarray(P.pl_tau) * np.asarray(P.pl_w)
            * np.asarray(P.pl_active),
            P.rg_ti, P.rg_tj, P.rg_q, P.rg_rho,
            np.asarray(P.rg_prec) * np.asarray(P.rg_w)
            * np.asarray(P.rg_active),
            kdiag=P.prior_kdiag, tdiag=P.prior_tdiag,
        )
    k = dims.k
    cols = np.asarray(E.cols)
    vals = np.asarray(E.vals)
    D = cols.shape[1]
    rows = np.repeat(np.arange(k), D)
    c, v = cols.ravel(), vals.ravel()
    m = c < k  # padding slots address the extra zero row k
    rows, c, v = rows[m], c[m], v[m]
    if E.ov_rows.shape[0]:
        rows = np.concatenate([rows, np.asarray(E.ov_rows)])
        c = np.concatenate([c, np.asarray(E.ov_cols)])
        v = np.concatenate([v, np.asarray(E.ov_vals)])
    return sp.coo_matrix((v, (rows, c)), shape=(k, k)).tocsr()


def _assemble_S_host(P: ProblemData, C: Certificate, dims: ProblemDims):
    """scipy CSR of S = Q - Lambda(X) (DCORA_utils.cpp:1898-1982)."""
    import scipy.sparse as sp

    k = dims.k
    n, d, l = dims.n, dims.d, dims.l  # noqa: E741
    Q = _Q_host(P, dims)
    rot = np.asarray(C.rot_blocks)  # [n, d, d]
    rows = (np.arange(n)[:, None, None] * d
            + np.broadcast_to(np.arange(d)[:, None], (n, d, d)))
    cols = (np.arange(n)[:, None, None] * d
            + np.broadcast_to(np.arange(d)[None, :], (n, d, d)))
    lam_rows = np.concatenate([rows.ravel(), n * d + np.arange(l)])
    lam_cols = np.concatenate([cols.ravel(), n * d + np.arange(l)])
    lam_vals = np.concatenate([rot.ravel(), np.asarray(C.sph_diag)])
    Lam = sp.coo_matrix((lam_vals, (lam_rows, lam_cols)),
                        shape=(k, k)).tocsr()
    return Q - Lam


def ldl_psd_proof(S) -> Optional[bool]:
    """Factorization-grade PSD proof of a sparse symmetric matrix.

    The analogue of the reference's CHOLMOD quick-return
    (isSparseSymmetricMatrixPSD, DCORA_utils.cpp:1737-1747): attempt a
    symmetric-permuted LDL^T via SuperLU in SymmetricMode with diagonal
    pivoting forced (diag_pivot_thresh=0).  When the factorization
    completes with perm_r == perm_c, the permuted matrix B = P S P^T
    satisfies B = L*U with unit-lower L, and symmetry + LDU uniqueness
    give U = diag(U) L^T, i.e. an LDL^T congruence — so by Sylvester's
    law the signs of diag(U) are the inertia of S.

    Returns True (all pivots decisively positive: S is PD), False (a
    decisively negative pivot: S has a negative eigenvalue), or None
    (inconclusive: pivoting deviated from the symmetric pattern, a pivot
    was too close to zero to trust, or the factorization failed).
    """
    from scipy.sparse.linalg import splu

    try:
        lu = splu(S.tocsc(), diag_pivot_thresh=0.0,
                  permc_spec="MMD_AT_PLUS_A",
                  options=dict(SymmetricMode=True))
    except (RuntimeError, ValueError, MemoryError):
        return None
    if not np.array_equal(lu.perm_r, lu.perm_c):
        return None  # off-diagonal pivoting: congruence argument void
    diag = lu.U.diagonal()
    scale = float(np.abs(diag).max()) if diag.size else 0.0
    tiny = 1e-12 * max(scale, 1.0)
    if float(diag.min()) > tiny:
        return True
    if float(diag.min()) < -tiny:
        return False
    return None


def _inertia_bracket_min_eig(S, eta: float, max_doublings: int = 40,
                             bisections: int = 10):
    """Bracket -lambda_min(S) using the LDL^T inertia oracle.

    Given that ldl_psd_proof(S + eta*I) returned False (a proven negative
    eigenvalue below -eta), find (lo, hi) with lambda_min in [-hi, -lo]
    by doubling t until S + t*I factors PD, then bisecting.  Each probe
    is one sparse factorization — the same primitive the reference's
    CHOLMOD quick-return uses (DCORA_utils.cpp:1737-1747), so ~a dozen
    probes cost about a dozen PSD checks.  Returns None if the oracle
    never concludes True (pathological pivoting)."""
    import scipy.sparse as sp

    k = S.shape[0]
    eye = sp.identity(k, format="csc")
    lo = eta
    hi = None
    t = max(2.0 * eta, 1e-10)
    for _ in range(max_doublings):
        pr = ldl_psd_proof(S + t * eye)
        if pr is True:
            hi = t
            break
        if pr is False:
            lo = t
        t *= 2.0
    if hi is None:
        return None
    for _ in range(bisections):
        mid = 0.5 * (lo + hi)
        pr = ldl_psd_proof(S + mid * eye)
        if pr is True:
            hi = mid
        elif pr is False:
            lo = mid
        else:
            break
    return lo, hi


def _min_eig_host(P: ProblemData, C: Certificate, dims: ProblemDims,
                  eta: float = 0.0
                  ) -> Tuple[bool, float, Optional[np.ndarray]]:
    """Fail-closed host check of lambda_min(S) >= -eta.

    Returns (certified, rayleigh, v). Lanczos Ritz values converge to
    lambda_min FROM ABOVE, so an unconverged device estimate can falsely
    certify (observed on single_drone.pyfg: spectral spread ~1e6 from
    range precisions made a -4.7e-3 bottom eigenvalue invisible to 40
    restarted 64-step sweeps).  The reference avoids this with an exact
    CHOLMOD factorization (isSparseSymmetricMatrixPSD,
    DCORA_utils.cpp:1737-1747) and a Spectra shift-invert fallback
    (:1749-1805).  This mirrors that structure:

      1. LDL^T proof of S + eta*I (ldl_psd_proof) — an actual
         factorization witness, also the cheap path at large k;
      2. otherwise ARPACK on shift*I - S with an explicit eigenpair
         residual check, LOBPCG fallback (also residual-checked);
      3. **fail closed**: if no solver produced a converged extreme
         eigenpair and no factorization succeeded, return not-certified
         (never certify from an unconverged vector — its Rayleigh
         quotient only upper-bounds lambda_min).

    A negative Rayleigh quotient below -eta remains a sound
    indefiniteness proof regardless of convergence (theta >= lambda_min).
    """
    import scipy.sparse as sp
    from scipy.sparse.linalg import ArpackNoConvergence, eigsh, lobpcg

    k = dims.k
    S = _assemble_S_host(P, C, dims)

    if eta > 0:
        proof = ldl_psd_proof(S + eta * sp.identity(k, format="csr"))
        if proof is True:
            return True, 0.0, None
        if proof is False:
            # Inertia PROVES lambda_min < -eta: the verdict is final and
            # must not be overridden by any eigen estimate (on tiers.pyfg
            # a spectrum-shifted ARPACK run "converged" in B-space at
            # absolute tolerance tol*shift >> eta to a clustered mix with
            # Rayleigh +0.013 while the true bottom eigenvalue was
            # -3.2e-3 — and falsely certified the rank).  Bracket
            # lambda_min with the same factorization oracle and pull an
            # escape direction by shift-invert inside the bracket: any v
            # with v^T S v < -eta is a sound descent direction.
            br = _inertia_bracket_min_eig(S, eta)
            if br is not None:
                lo, hi = br
                sigma = -0.5 * (lo + hi)
                try:
                    _, Vv = eigsh(S, k=1, sigma=sigma, which="LM",
                                  maxiter=1000)
                    v = Vv[:, 0]
                    v = v / np.linalg.norm(v)
                    Sv = S @ v
                    theta = float(v @ Sv)
                    if theta + eta < 0:
                        return False, theta, v
                except Exception:  # noqa: BLE001
                    pass
                return False, -0.5 * (lo + hi), None
            return False, -eta, None
        # proof None (inconclusive): resolve the bottom eigenpair below

    lam_max = float(eigsh(S, k=1, which="LA", return_eigenvectors=False,
                          tol=1e-4, ncv=min(k, 50))[0])
    shift = 1.01 * max(lam_max, 1e-6)
    B = (shift * sp.identity(k, format="csr") - S).tocsr()
    rng = np.random.default_rng(0)
    v, converged = None, False
    for ncv in (min(k, 96), min(k, 256)):
        try:
            # bounded restart budget: in the saddle case the extreme of B
            # is isolated and ARPACK converges in a few cycles; in the
            # clustered (near-PSD) case no budget converges and the LDL^T
            # early-return above already settled PSD — an unbounded cap
            # (40*k) only buys a multi-minute grind before the fallback
            _, vecs = eigsh(B, k=1, which="LA", tol=1e-7,
                            ncv=ncv, maxiter=500,
                            v0=rng.standard_normal(k))
            v, converged = vecs[:, 0], True
            break
        except ArpackNoConvergence as e:
            if len(e.eigenvectors) and e.eigenvectors.shape[1]:
                v = e.eigenvectors[:, -1]  # kept only as a candidate
    if not converged:
        Xb = rng.standard_normal((k, min(k, 8)))
        if v is not None:
            Xb[:, 0] = v
        w, Vb = lobpcg(B, Xb, tol=1e-7, maxiter=2000, largest=True)
        v = Vb[:, int(np.argmax(w))]
    v = v / np.linalg.norm(v)
    Sv = S @ v
    theta = float(v @ Sv)
    resid = float(np.linalg.norm(Sv - theta * v))
    if theta + eta < 0:
        return False, theta, v  # sound: theta >= lambda_min
    # Accept a PSD verdict only when the S-space residual is tiny.
    # ARPACK's own convergence flag is NOT sufficient: its criterion is
    # relative to B = shift*I - S whose scale is lam_max, so a "converged"
    # vector can carry O(tol * lam_max) >> eta Rayleigh error in S-space
    # (the tiers.pyfg false certificate).
    res_ok = resid <= max(1e-8 * max(abs(lam_max), 1.0), 1e-12)
    del converged  # diagnostic only; never a soundness basis
    if res_ok:
        return theta + eta >= 0, theta, v
    import logging

    logging.getLogger(__name__).warning(
        "PSD check inconclusive (resid=%.3e, theta=%.3e): failing closed",
        resid, theta,
    )
    return False, theta, v


def fast_verification(P: ProblemData, X: RAState, eta: float,
                      num_lanczos: int = 64, TP=None):
    """Check S + eta*I >= 0 (reference: fastVerification,
    DCORA_utils.cpp:1713-1735).

    Returns (is_psd, theta, min_eigenvector) where theta = v^T S v for the
    estimated minimum eigenvector (0, None when certified).

    Soundness split: "not PSD" conclusions are validated by an exact f64
    Rayleigh quotient (theta >= lambda_min, so a negative theta proves
    indefiniteness); "PSD" conclusions cannot be proven by Lanczos (Ritz
    values approach lambda_min from above) and are confirmed by the
    factorization-grade host check (_min_eig_host), the analogue of the
    reference's CHOLMOD PSD test.  PSD happens once per staircase, so the
    host confirmation amortizes.

    With TP (a tiled.TiledProblem), the min-eig search first runs on the
    tiled f32 path, which settles the common not-PSD case cheaply.
    """
    C = dual_certificate_blocks(P, X)
    dims = X.dims
    if TP is not None:
        lam_est, v_est = minimum_eigen_pair_tiled(TP, X, num_lanczos)
        vj = jnp.asarray(v_est)
        vj = vj / jnp.linalg.norm(vj)
        Sv = _flat_matvec(P, C, dims, 0.0)(vj)
        theta = float(jnp.vdot(vj, Sv))
        if theta + eta < 0:
            return False, theta, np.asarray(vj)
        # fall through to the exact search to certify PSD soundly
    lam_min, v, resid = minimum_eigen_pair(P, C, dims, num_lanczos)
    if lam_min + eta < 0:
        # curvature along the estimated eigenvector w.r.t. S itself
        vj = jnp.asarray(v)
        Sv = _flat_matvec(P, C, dims, 0.0)(vj)
        theta = float(jnp.vdot(vj, Sv))
        if theta + eta < 0:
            return False, theta, v
    # device Lanczos believes lam_min(S) >= -eta: confirm on host
    certified, lam_host, v_host = _min_eig_host(P, C, dims, eta)
    if certified:
        return True, 0.0, None
    return False, lam_host, v_host if v_host is not None else v


# --------------------------------------------------------------------------
# Saddle escape (reference: QuadraticProblem.cpp:138-234)
# --------------------------------------------------------------------------


def escape_saddle(P: ProblemData, X_opt: RAState, theta: float,
                  v: np.ndarray, r_target: int,
                  gradient_tolerance: float = 1e-6,
                  preconditioned_gradient_tolerance: float = 1e-6,
                  M=None, is_second_order: bool = False
                  ) -> Tuple[bool, Optional[RAState]]:
    """Lift a rank-(r-1) critical point and descend along the min-eig
    direction with a backtracking retraction line search."""
    dims = X_opt.dims
    r_prev = X_opt.r
    assert r_target == r_prev + 1
    X_plus = lifted.pad_rank(X_opt, r_target)
    # escape direction: min eigenvector on the NEW bottom row
    Vdir_flat = jnp.zeros((r_target, dims.k)).at[r_target - 1].set(
        jnp.asarray(v)
    )
    X_dot = lifted.from_flat(Vdir_flat, dims)

    G = lifted.zeros(dims, r_target)

    def f(Xs):
        return float(prob.cost(P, Xs, G))

    alpha_min = 1e-6
    # Backtrack from alpha >= 1, never only from the second-order
    # heuristic step 100*gtol/|theta| (SE-Sync Alg. 7 / reference
    # QuadraticProblem.cpp:138-234).  The heuristic assumes the iterate
    # is critical to ~gradient_tolerance; the staircase converges ranks
    # to their solver floor (1e-3..1e-4), where a heuristic alpha of
    # O(1e-5) yields a curvature gain of 0.5*|theta|*alpha^2 ~ 1e-9 —
    # BELOW the constant retraction-projection offset of evaluating f at
    # the retracted trial (+1.4e-9 measured on tiers.pyfg rank 2,
    # theta=-4.7), so every trial read as an increase and a decisively
    # negative direction was rejected.  At alpha ~ 1 the decrease is
    # O(|theta|) and unambiguous; halving handles any overshoot.
    alpha = (max(1.0, 100 * gradient_tolerance / abs(theta))
             if is_second_order else 1.0)

    # one compiled call per line-search trial (the eager form dispatched
    # ~40 small ops per trial, each paying host dispatch latency)
    @jax.jit
    def _trial(alpha_j):
        Xtest = retract(X_plus, X_dot.scale(alpha_j))
        ftest = prob.cost(P, Xtest, G)
        g = tangent_project(Xtest, prob.euclidean_gradient(P, Xtest, G))
        gnorm = g.norm()
        if M is not None:
            pg = tangent_project(Xtest, prob.apply_preconditioner(M, g))
            pgnorm = pg.norm()
        else:
            pgnorm = gnorm
        return ftest, gnorm, pgnorm

    # Baseline at the RETRACTED lift: retraction re-projects the trial
    # point, shifting f by a constant O(1e-9) independent of alpha; the
    # un-retracted f(X_plus) baseline mixes that offset into the
    # decrease test (see the alpha note above).
    fX_plus = f(retract(X_plus, X_dot.scale(0.0)))
    alphas, fvals = [], []
    while alpha >= alpha_min:
        ftest_j, gnorm_j, pgnorm_j = _trial(jnp.asarray(alpha))
        ftest, gnorm, pgnorm = (float(ftest_j), float(gnorm_j),
                                float(pgnorm_j))
        alphas.append(alpha)
        fvals.append(ftest)
        if (ftest < fX_plus and gnorm > gradient_tolerance
                and pgnorm > preconditioned_gradient_tolerance):
            return True, retract(X_plus, X_dot.scale(alpha))
        alpha /= 2
    # fall back to the best strictly-decreasing trial point
    i_min = int(np.argmin(fvals))
    if fvals[i_min] < fX_plus:
        return True, retract(X_plus, X_dot.scale(alphas[i_min]))
    return False, None


# --------------------------------------------------------------------------
# Solution rounding (reference: projectSolutionRASLAM,
# DCORA_utils.cpp:1984-2031, CORA Alg. 3)
# --------------------------------------------------------------------------


def round_solution(X: RAState) -> RAState:
    """Round a rank-r solution to rank d: thin SVD of X^T, det-majority
    reflection, project rotations to SO(d) and spheres to the unit sphere."""
    dims = X.dims
    d = dims.d
    Xflat = lifted.to_flat(X)  # [r, k]
    U, s, Vt = jnp.linalg.svd(Xflat.T, full_matrices=False)
    Xd_flat = (U[:, :d] * s[:d]).T  # [d, k]
    Xd = lifted.from_flat(Xd_flat, dims)
    # reflect if fewer than half of the rotation blocks have positive det
    dets = jnp.linalg.det(Xd.rot)
    num_pos = jnp.sum(dets > 0)
    refl = jnp.where(num_pos < dims.n / 2.0, -1.0, 1.0)
    R = jnp.eye(d).at[d - 1, d - 1].set(refl)
    # left-multiply every column block by R (acting on the rank dims)
    # R acts on the rank (row) dimension of every column block
    Xd = RAState(
        rot=jnp.einsum("ij,njc->nic", R, Xd.rot),
        sph=jnp.einsum("ij,lj->li", R, Xd.sph),
        trn=jnp.einsum("ij,tj->ti", R, Xd.trn),
    )
    return RAState(
        rot=rotation_project(Xd.rot),
        sph=oblique_project(Xd.sph),
        trn=Xd.trn,
    )
