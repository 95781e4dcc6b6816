"""Sharded certification: the Lanczos SpMV distributed over a device mesh.

The reference certifies centrally (Spectra Lanczos over one sparse S,
DCORA_utils.cpp:1807-1896, assembled on the driver). For problems sharded
across chips/hosts the dominant cost is the S matvec; here it becomes

    S v  =  psum_a( v Q_a )  -  v Lambda(X)  ,

where Q_a holds an edge shard: the measurement SoA axis is split across
the mesh, every device computes the gather/scatter contributions of its
edges into a full-size output, and one psum over the mesh reduces them
(SURVEY.md 2.3 "distributed certification": local SpMV + psum). The
Lambda(X) term is block-diagonal and cheap, applied replicated.

Edge shards are padded with zero-weight entries, so any mesh size divides
any problem. The Lanczos iteration itself (full reorthogonalization,
spectrum shifting as in core.certify) runs replicated: its vectors are
[k]-sized, negligible next to the edge work.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from dcora_tpu.core import lifted, problem as prob
from dcora_tpu.core.certify import Certificate, dual_certificate_blocks
from dcora_tpu.core.lifted import RAState
from dcora_tpu.core.problem import ProblemData
from dcora_tpu.types import ProblemDims

_PP = ("pp_ri", "pp_rj", "pp_ti", "pp_tj", "pp_R", "pp_t", "pp_kappa",
       "pp_tau", "pp_w", "pp_active")
_PL = ("pl_ri", "pl_ti", "pl_tj", "pl_t", "pl_tau", "pl_w", "pl_active")
_RG = ("rg_ti", "rg_tj", "rg_q", "rg_rho", "rg_prec", "rg_w", "rg_active")


def _split_group(P_in: ProblemData, names, A: int):
    """Split one edge group's arrays into A padded chunks [A, chunk, ...].
    Padding entries carry weight 0 (their index-0 gathers contribute
    nothing)."""
    m = getattr(P_in, names[0]).shape[0]
    chunk = max(1, -(-m // A))
    out = {}
    for name in names:
        arr = np.asarray(getattr(P_in, name))
        pad = A * chunk - m
        if pad:
            pad_block = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
            arr = np.concatenate([arr, pad_block], axis=0)
        out[name] = jnp.asarray(arr.reshape((A, chunk) + arr.shape[1:]))
    return out


def shard_problem_edges(P_in: ProblemData, num_shards: int) -> ProblemData:
    """ProblemData with every edge array reshaped to [A, chunk, ...].

    Prior quadratic diagonals are scaled by 1/A on every shard (they are
    additive, so the psum reconstructs them exactly). The ELL form and the
    prior linear term do not participate in the S matvec and are dropped.
    """
    A = num_shards
    fields = {}
    for group in (_PP, _PL, _RG):
        fields.update(_split_group(P_in, group, A))
    kd = P_in.prior_kdiag
    td = P_in.prior_tdiag
    if kd is not None:
        kd = jnp.broadcast_to(kd / A, (A,) + kd.shape)
    if td is not None:
        td = jnp.broadcast_to(td / A, (A,) + td.shape)
    return P_in._replace(
        **fields, prior_kdiag=kd, prior_tdiag=td, prior_G=None, ell=None,
    )


def _make_sharded_applyQ_flat(dims: ProblemDims, mesh: Mesh, axis: str):
    """shard_map'd  v -> v Q  over edge shards, flat [k] interface."""
    from jax import shard_map

    def shard_fn(P_a, v):
        # shard_map keeps the sharded leading axis at local size 1
        P_local = jax.tree.map(lambda x: x[0], P_a)
        V = lifted.from_flat(v[None, :], dims)
        W = prob.apply_Q(P_local, V, prefer_ell=False)
        return jax.lax.psum(lifted.to_flat(W)[0], axis)

    def specs_of(tree):
        return jax.tree.map(lambda _: P(axis), tree)

    def apply(P_sh, v):
        return shard_map(
            shard_fn, mesh=mesh,
            in_specs=(specs_of(P_sh), P()),
            out_specs=P(),
        )(P_sh, v)

    return apply


def make_sharded_matvec(P_sh: ProblemData, C: Certificate,
                        dims: ProblemDims, mesh: Mesh,
                        axis: str = "agents"):
    """v -> v S (+ shift v) with the Q part psum-sharded over the mesh."""
    applyQ = _make_sharded_applyQ_flat(dims, mesh, axis)
    n, l = dims.n, dims.l  # noqa: E741
    d = dims.d

    def mv(v, shift):
        w = applyQ(P_sh, v)
        V = lifted.from_flat(v[None, :], dims)
        lam = RAState(
            rot=jnp.einsum("nrd,nde->nre", V.rot, C.rot_blocks),
            sph=V.sph * C.sph_diag[:, None],
            trn=jnp.zeros_like(V.trn),
        )
        return w - lifted.to_flat(lam)[0] + shift * v

    return mv


def _lanczos(mv, k: int, shift, v0, m: int):
    """Largest-magnitude Ritz pair of (S + shift I) after m steps, full
    reorthogonalization (mirrors core.certify._lanczos_extreme)."""
    basis = jnp.zeros((m, k))
    alphas = jnp.zeros((m,))
    betas = jnp.zeros((m,))
    v = v0 / jnp.linalg.norm(v0)

    def body(j, carry):
        basis, alphas, betas, v = carry
        basis = basis.at[j].set(v)
        w = mv(v, shift)
        a = jnp.vdot(v, w)
        alphas = alphas.at[j].set(a)
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        b = jnp.linalg.norm(w)
        betas = betas.at[j].set(b)
        fresh = jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(0), j), (k,)
        )
        for _ in range(2):
            fresh = fresh - basis.T @ (basis @ fresh)
        fresh = fresh / jnp.maximum(jnp.linalg.norm(fresh), 1e-300)
        v_next = jnp.where(b > 1e-12, w / jnp.where(b == 0, 1.0, b), fresh)
        return basis, alphas, betas, v_next

    basis, alphas, betas, _ = jax.lax.fori_loop(
        0, m, body, (basis, alphas, betas, v)
    )
    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1)
         + jnp.diag(betas[:-1], -1))
    evals, evecs = jnp.linalg.eigh(T)
    idx = jnp.argmax(jnp.abs(evals))
    return evals[idx], basis.T @ evecs[:, idx], \
        jnp.abs(betas[m - 1] * evecs[m - 1, idx])


def minimum_eigen_pair_sharded(
    P_in: ProblemData, C: Certificate, dims: ProblemDims, mesh: Mesh,
    num_lanczos: int = 64, axis: str = "agents",
    P_sh: Optional[ProblemData] = None,
) -> Tuple[float, np.ndarray, float]:
    """(lambda_min, eigvec, residual) of S with the SpMV sharded over
    ``mesh``. Pass a prebuilt ``P_sh`` (shard_problem_edges) to amortize
    the sharding across calls."""
    A = mesh.shape[axis]
    if P_sh is None:
        P_sh = shard_problem_edges(P_in, A)
    mv = make_sharded_matvec(P_sh, C, dims, mesh, axis)
    m = min(num_lanczos, dims.k)

    lanczos = jax.jit(partial(_lanczos, mv, dims.k), static_argnames="m")

    rng = np.random.default_rng(0)
    v0 = jnp.asarray(rng.standard_normal(dims.k))
    lam_lm, y_lm, res_lm = lanczos(jnp.zeros(()), v0, m=m)
    lam_lm_f = float(lam_lm)
    if lam_lm_f < 0:
        return lam_lm_f, np.asarray(y_lm), float(res_lm)

    e0 = jnp.zeros(dims.k).at[0].set(1.0)
    row0 = mv(e0, jnp.zeros(()))
    pert = rng.standard_normal(dims.k)
    pert /= np.linalg.norm(pert)
    v0s = row0 + 0.03 * jnp.linalg.norm(row0) * jnp.asarray(pert)
    if float(jnp.linalg.norm(v0s)) < 1e-12:
        v0s = jnp.asarray(rng.standard_normal(dims.k))
    # restarted sweeps (see core.certify.minimum_eigen_pair: Ritz values
    # approach lambda_min from above; a single sweep can miss a clustered
    # bottom eigenvalue and falsely certify)
    lam_best, y_best, res_best = None, None, 0.0
    stagnant = 0
    for _ in range(40):
        lam_s, y_s, res_s = lanczos(-2.0 * lam_lm, v0s, m=m)
        lam_cur = float(lam_s + 2.0 * lam_lm)
        if lam_best is not None and \
                lam_cur > lam_best - max(1e-12, 1e-9 * abs(lam_lm_f)):
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        # keep (value, vector, residual) consistent (a regressed sweep
        # must not overwrite the vector of the best value)
        if lam_best is None or lam_cur < lam_best:
            lam_best, y_best, res_best = lam_cur, y_s, res_s
        v0s = jnp.asarray(y_s)
    return lam_best, np.asarray(y_best), float(res_best)


def fast_verification_sharded(P_in: ProblemData, X: RAState, eta: float,
                              mesh: Mesh, num_lanczos: int = 64,
                              axis: str = "agents"):
    """Sharded analogue of core.certify.fast_verification: returns
    (is_psd, theta, min_eigenvector)."""
    C = dual_certificate_blocks(P_in, X)
    dims = X.dims
    A = mesh.shape[axis]
    P_sh = shard_problem_edges(P_in, A)
    lam_min, v, resid = minimum_eigen_pair_sharded(
        P_in, C, dims, mesh, num_lanczos, axis, P_sh=P_sh
    )
    if lam_min + eta < 0:
        mv = make_sharded_matvec(P_sh, C, dims, mesh, axis)
        vj = jnp.asarray(v)
        vj = vj / jnp.linalg.norm(vj)
        theta = float(jnp.vdot(vj, mv(vj, jnp.zeros(()))))
        if theta + eta < 0:  # exact Rayleigh: proves indefiniteness
            return False, theta, np.asarray(vj)
    # PSD conclusions cannot be proven by Lanczos (Ritz values approach
    # lambda_min from above): confirm with the factorization-grade host
    # check, as core.certify.fast_verification does.  PSD happens once
    # per staircase, so the host confirmation amortizes.
    from dcora_tpu.core.certify import _min_eig_host

    certified, lam_host, v_host = _min_eig_host(P_in, C, dims, eta)
    if certified:
        return True, 0.0, None
    return False, lam_host, v_host if v_host is not None else np.asarray(v)
