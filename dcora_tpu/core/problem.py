"""Matrix-free quadratic cost engine.

Implements the lifted cost  f(X) = 0.5 <Q, X^T X> + <X, G>  (reference:
QuadraticProblem.h:30-40, QuadraticProblem.cpp:38-84) without ever forming a
general sparse matrix. Q is represented by its measurement SoA arrays and
applied by gather -> batched einsum -> segment-sum, which is the JAX
replacement for the reference's Eigen sparse AᵀΩA construction
(Graph.cpp:579-683, 824-1188) *and* its SpMV `EucHessianEta`
(QuadraticProblem.cpp:61-68) at once.

Closed-form per-edge blocks of Q (RA ordering; w = weight,
kw = w*kappa, tw = w*tau, om = w*precision):

  pose-pose (tail i, head j):                        [Graph.cpp:579-683]
      Q[rot_i,rot_i] += kw I + tw t tᵀ     Q[rot_i,rot_j] += -kw R
      Q[rot_j,rot_j] += kw I               Q[rot_i,trn_i] += tw t
      Q[rot_i,trn_j] += -tw t              Q[trn,trn] Laplacian (+tw)
  pose-landmark (tail pose i, head landmark j):      [Graph.cpp:988-1031]
      same tau rows with kw = 0
  range (tail trans a, head trans b, sphere q, range rho):
      Q[sph_q,sph_q] += om rho^2           Q[sph_q,trn_a] += -om rho
      Q[sph_q,trn_b] += om rho             Q[trn,trn] Laplacian (+om)
                                                     [Graph.cpp:1040-1188]

Applied to the state these give, with s = Y_i t + t_i - t_j (the lifted
translation residual) and g = rho*s_q + (t_b - t_a):

      (XQ)_rot_i += kw (Y_i - Y_j Rᵀ) + tw s ⊗ t
      (XQ)_rot_j += kw (Y_j - Y_i R)
      (XQ)_trn_i += tw s          (XQ)_trn_j -= tw s
      (XQ)_sph_q += om rho g
      (XQ)_trn_a -= om g          (XQ)_trn_b += om g

Distributed (agent-local) problems use the *augmented space* formulation:
fixed neighbor public states are appended as frozen extra variables, so the
linear term G = X_fixed^T Q_cb (reference: Graph.cpp:1200-1227) is just the
restriction of the same apply_Q to the local slots -- one code path serves
the centralized problem, the agent subproblem, and G construction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dcora_tpu.core.lifted import RAState


class ProblemData(NamedTuple):
    """Measurement SoA over the augmented index space (local slots first).

    Index spaces:
      rotation blocks: [0, n_local) local poses, then fixed neighbor poses
      translations:    [0, n_local) pose trans, [n_local, n_local+b) landmarks,
                       then fixed neighbor translations (poses & landmarks)
      spheres:         [0, l_local) local, then fixed neighbor spheres
    """

    # pose-pose edges
    pp_ri: jax.Array  # i32[mpp] tail rotation index
    pp_rj: jax.Array  # i32[mpp] head rotation index
    pp_ti: jax.Array  # i32[mpp] tail translation index
    pp_tj: jax.Array  # i32[mpp] head translation index
    pp_R: jax.Array  # f64[mpp, d, d]
    pp_t: jax.Array  # f64[mpp, d]
    pp_kappa: jax.Array  # f64[mpp]
    pp_tau: jax.Array  # f64[mpp]
    pp_w: jax.Array  # f64[mpp] robust weight
    pp_active: jax.Array  # f64[mpp] activity mask (0/1)

    # pose-landmark edges
    pl_ri: jax.Array  # i32[mpl] tail rotation index
    pl_ti: jax.Array  # i32[mpl] tail translation index
    pl_tj: jax.Array  # i32[mpl] head (landmark) translation index
    pl_t: jax.Array  # f64[mpl, d]
    pl_tau: jax.Array  # f64[mpl]
    pl_w: jax.Array  # f64[mpl]
    pl_active: jax.Array  # f64[mpl]

    # range edges
    rg_ti: jax.Array  # i32[mrg] tail translation index
    rg_tj: jax.Array  # i32[mrg] head translation index
    rg_q: jax.Array  # i32[mrg] sphere index
    rg_rho: jax.Array  # f64[mrg] measured range
    rg_prec: jax.Array  # f64[mrg] precision
    rg_w: jax.Array  # f64[mrg]
    rg_active: jax.Array  # f64[mrg]

    # linear prior term over LOCAL slots (reference: Graph.cpp:805-817),
    # rank-independent factorized form: G_prior = -YLift-lifted prior blocks.
    # Stored at rank of use; zeros when no priors.
    prior_G: Optional[RAState]

    # quadratic prior diagonals over LOCAL slots (reference: the kappa I /
    # tau terms a prior adds to Q, Graph.cpp:314-331).  Without these the
    # prior cost 0.5*k||Y-P||^2 + 0.5*t||p-q||^2 would reduce to its linear
    # part and be unbounded below.  None when there are no priors.
    prior_kdiag: Optional[jax.Array] = None  # f64[n] kappa per local pose
    prior_tdiag: Optional[jax.Array] = None  # f64[n+b] tau per local trans

    # optional ELLPACK form of the LOCAL Q (scalar sparse, RA column
    # ordering); the gather-only fast path for apply_Q -- see EllQ
    ell: "Optional[EllQ]" = None

    @property
    def num_pose_pose(self) -> int:
        return self.pp_ri.shape[0]


class EllQ(NamedTuple):
    """ELLPACK representation of the local block Q_bb at scalar granularity.

    Rationale: XLA scatter (segment_sum) with tiny inner dims runs far
    from memory bandwidth; a fixed-width row layout turns the SpMM
    W = X Q into one regular gather + einsum with no scatter at all.
    Column ordering follows the reference's RA layout (Elements.h:178-183):
    rotations [n*d], unit spheres [l], translations [n+b].  Rows wider than
    the ELL width spill into a small COO overflow handled by segment_sum.
    Padding slots point at the extra zero row k (cols == k, vals == 0).
    """

    cols: jax.Array  # i32[k, D] column index per slot (k = pad row)
    vals: jax.Array  # f64[k, D]
    ov_rows: jax.Array  # i32[novf] overflow COO
    ov_cols: jax.Array  # i32[novf]
    ov_vals: jax.Array  # f64[novf]


def _apply_ell(E: "EllQ", X: RAState) -> RAState:
    n, r, d = X.rot.shape
    l = X.sph.shape[0]  # noqa: E741
    dtype = X.rot.dtype
    Xf = jnp.concatenate([
        jnp.swapaxes(X.rot, 1, 2).reshape(n * d, r),
        X.sph,
        X.trn,
        jnp.zeros((1, r), dtype),
    ])
    Wg = Xf[E.cols]  # [k, D, r]
    W = jnp.einsum("kdr,kd->kr", Wg, E.vals.astype(dtype))
    if E.ov_rows.shape[0]:
        contrib = Xf[E.ov_cols] * E.ov_vals.astype(dtype)[:, None]
        W = W + _seg(contrib, E.ov_rows, Xf.shape[0])[:-1]
    return RAState(
        rot=jnp.swapaxes(W[: n * d].reshape(n, d, r), 1, 2),
        sph=W[n * d:n * d + l],
        trn=W[n * d + l:],
    )


def build_ell(n: int, l: int, b: int, d: int,  # noqa: E741
              pp_ri, pp_rj, pp_ti, pp_tj, pp_R, pp_t, pp_kw, pp_tw,
              pl_ri, pl_ti, pl_tj, pl_t, pl_tw,
              rg_ti, rg_tj, rg_q, rg_rho, rg_om,
              width_cap: int = 48, kdiag=None, tdiag=None) -> "EllQ":
    """Host-side assembly of the local scalar Q in ELL form.

    Index arrays live in the *augmented* spaces; entries whose row or
    column falls outside the local spaces are dropped (they belong to the
    Q_bc blocks handled by linear_term).  Weights (kw/tw/om) are the
    products kappa*w*active etc., so a weight change requires a rebuild
    (GNC epochs only -- the RBCD hot loop never rebuilds Q_bb).
    """
    import numpy as np
    import scipy.sparse as sp

    nd = n * d
    k = nd + l + (n + b)
    t_off = nd + l  # translation column offset

    rows_all, cols_all, vals_all, ok_all = [], [], [], []
    ar = np.arange(d)

    def emit(rid, rok, cid, cok, v):
        rid, cid, v = np.broadcast_arrays(rid, cid, v)
        ok = np.broadcast_arrays(rok & cok, v)[0]
        rows_all.append(rid.ravel())
        cols_all.append(cid.ravel())
        vals_all.append(v.ravel())
        ok_all.append(ok.ravel())

    mpp = len(pp_ri)
    if mpp:
        ri, rj = np.asarray(pp_ri), np.asarray(pp_rj)
        ti, tj = np.asarray(pp_ti), np.asarray(pp_tj)
        R, t = np.asarray(pp_R), np.asarray(pp_t)
        kw, tw = np.asarray(pp_kw), np.asarray(pp_tw)
        # scalar rotation ids, masked with the section-local bound: a fixed
        # rotation (ri >= n_aug_local) must not alias sphere/trn columns
        Ri = ri[:, None] * d + ar  # [m, d]
        Rj = rj[:, None] * d + ar
        Ri_ok = (ri < n)[:, None] & np.ones(d, bool)
        Rj_ok = (rj < n)[:, None] & np.ones(d, bool)

        eye = np.eye(d)
        # tail rot-rot diag: kw I + tw t t^T
        emit(Ri[:, :, None], Ri_ok[:, :, None], Ri[:, None, :],
             Ri_ok[:, None, :],
             kw[:, None, None] * eye
             + tw[:, None, None] * t[:, :, None] * t[:, None, :])
        # head rot-rot diag: kw I
        emit(Rj, Rj_ok, Rj, Rj_ok, np.broadcast_to(kw[:, None], (mpp, d)))
        # cross: Q[rot_i, rot_j] = -kw R (and its transpose)
        V = -kw[:, None, None] * R
        emit(Ri[:, :, None], Ri_ok[:, :, None], Rj[:, None, :],
             Rj_ok[:, None, :], V)
        emit(Rj[:, None, :], Rj_ok[:, None, :], Ri[:, :, None],
             Ri_ok[:, :, None], V)
        # rot-trans: Q[rot_i, trn_i] = tw t; Q[rot_i, trn_j] = -tw t (+sym)
        Ti = t_off + ti
        Tj = t_off + tj
        Ti_ok = ti < (n + b)
        Tj_ok = tj < (n + b)
        v = tw[:, None] * t
        emit(Ri, Ri_ok, Ti[:, None], Ti_ok[:, None], v)
        emit(Ti[:, None], Ti_ok[:, None], Ri, Ri_ok, v)
        emit(Ri, Ri_ok, Tj[:, None], Tj_ok[:, None], -v)
        emit(Tj[:, None], Tj_ok[:, None], Ri, Ri_ok, -v)
        # translation Laplacian
        emit(Ti, Ti_ok, Ti, Ti_ok, tw)
        emit(Tj, Tj_ok, Tj, Tj_ok, tw)
        emit(Ti, Ti_ok, Tj, Tj_ok, -tw)
        emit(Tj, Tj_ok, Ti, Ti_ok, -tw)

    mpl = len(pl_ri)
    if mpl:
        ri = np.asarray(pl_ri)
        ti, tj = np.asarray(pl_ti), np.asarray(pl_tj)
        t, tw = np.asarray(pl_t), np.asarray(pl_tw)
        Ri = ri[:, None] * d + ar
        Ri_ok = (ri < n)[:, None] & np.ones(d, bool)
        Ti = t_off + ti
        Tj = t_off + tj
        Ti_ok = ti < (n + b)
        Tj_ok = tj < (n + b)

        emit(Ri[:, :, None], Ri_ok[:, :, None], Ri[:, None, :],
             Ri_ok[:, None, :],
             tw[:, None, None] * t[:, :, None] * t[:, None, :])
        v = tw[:, None] * t
        emit(Ri, Ri_ok, Ti[:, None], Ti_ok[:, None], v)
        emit(Ti[:, None], Ti_ok[:, None], Ri, Ri_ok, v)
        emit(Ri, Ri_ok, Tj[:, None], Tj_ok[:, None], -v)
        emit(Tj[:, None], Tj_ok[:, None], Ri, Ri_ok, -v)
        emit(Ti, Ti_ok, Ti, Ti_ok, tw)
        emit(Tj, Tj_ok, Tj, Tj_ok, tw)
        emit(Ti, Ti_ok, Tj, Tj_ok, -tw)
        emit(Tj, Tj_ok, Ti, Ti_ok, -tw)

    mrg = len(rg_ti)
    if mrg:
        ta, tb = np.asarray(rg_ti), np.asarray(rg_tj)
        q = np.asarray(rg_q)
        rho, om = np.asarray(rg_rho), np.asarray(rg_om)
        Sq = nd + q
        Sq_ok = q < l
        Ta = t_off + ta
        Tb = t_off + tb
        Ta_ok = ta < (n + b)
        Tb_ok = tb < (n + b)

        emit(Sq, Sq_ok, Sq, Sq_ok, om * rho * rho)
        emit(Sq, Sq_ok, Ta, Ta_ok, -om * rho)
        emit(Ta, Ta_ok, Sq, Sq_ok, -om * rho)
        emit(Sq, Sq_ok, Tb, Tb_ok, om * rho)
        emit(Tb, Tb_ok, Sq, Sq_ok, om * rho)
        emit(Ta, Ta_ok, Ta, Ta_ok, om)
        emit(Tb, Tb_ok, Tb, Tb_ok, om)
        emit(Ta, Ta_ok, Tb, Tb_ok, -om)
        emit(Tb, Tb_ok, Ta, Ta_ok, -om)

    # prior quadratic diagonals (Graph.cpp:314-331)
    if kdiag is not None:
        kd = np.asarray(kdiag)
        Ri = np.arange(n)[:, None] * d + ar
        ok = np.ones_like(Ri, bool)
        emit(Ri, ok, Ri, ok, np.broadcast_to(kd[:, None], (n, d)))
    if tdiag is not None:
        td = np.asarray(tdiag)
        Ti = t_off + np.arange(n + b)
        ok = np.ones_like(Ti, bool)
        emit(Ti, ok, Ti, ok, td)

    if rows_all:
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
        vals = np.concatenate(vals_all)
        ok = np.concatenate(ok_all)
        rows, cols, vals = rows[ok], cols[ok], vals[ok]
    else:
        rows = cols = np.zeros(0, np.int64)
        vals = np.zeros(0)

    A = sp.coo_matrix((vals, (rows, cols)), shape=(k, k)).tocsr()
    A.sum_duplicates()
    nnz_per_row = np.diff(A.indptr)
    D = max(int(nnz_per_row.max(initial=0)), 1)
    D = min(D, width_cap)
    cols_ell = np.full((k, D), k, np.int32)
    vals_ell = np.zeros((k, D))
    rank = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
    row_ids = np.repeat(np.arange(k), nnz_per_row)
    in_ell = rank < D
    cols_ell[row_ids[in_ell], rank[in_ell]] = A.indices[in_ell]
    vals_ell[row_ids[in_ell], rank[in_ell]] = A.data[in_ell]
    ov = ~in_ell
    return EllQ(
        cols=jnp.asarray(cols_ell),
        vals=jnp.asarray(vals_ell),
        ov_rows=jnp.asarray(row_ids[ov].astype(np.int32)),
        ov_cols=jnp.asarray(A.indices[ov].astype(np.int32)),
        ov_vals=jnp.asarray(A.data[ov]),
    )


def _seg(contrib, idx, num):
    return jax.ops.segment_sum(contrib, idx, num_segments=num)


def apply_Q(P: ProblemData, X: RAState,
            prefer_ell: bool = False) -> RAState:
    """W = X Q arranged in the same block layout as X (Q is symmetric).

    Replaces EucHessianEta / EucGrad SpMV (QuadraticProblem.cpp:53-68). X may
    be the augmented state (local + fixed) or the centralized state.

    Index-space contract: any edge-endpoint index equal to the size of the
    corresponding part of X addresses an implicit zero "padding" row: it
    gathers zeros and its scattered contribution is discarded. Agent-local
    subproblems exploit this by remapping fixed-neighbor slots to the pad
    slot, which makes apply_Q on a local-shaped state exactly the Q_bb
    block operator.

    When P carries an ELL form of the local Q (P.ell), X is local-shaped
    (flat size matches -- a static check under jit), and `prefer_ell`, the
    scatter-free ELL fast path is used instead of gather/segment-sum.

    Numerics: the ELL path multiplies out the scalar entries of Q (like the
    reference's assembled sparse matrix), so applying it to a state X near
    the optimum loses ~6 digits to cancellation (Y_i ~ Y_j R^T); the edge
    path computes the residual s = Y_i t + t_i - t_j *before* multiplying
    and does not.  Gradient/cost therefore default to the edge path, while
    hessian_vec (the tCG hot loop, acting on small tangent vectors with no
    such cancellation) uses ELL.
    """
    if prefer_ell and P.ell is not None:
        n_, r_, d_ = X.rot.shape
        k_flat = n_ * d_ + X.sph.shape[0] + X.trn.shape[0]
        if k_flat == P.ell.cols.shape[0]:
            return _apply_ell(P.ell, X)
    n_aug = X.rot.shape[0]
    t_aug = X.trn.shape[0]
    l_aug = X.sph.shape[0]
    r = X.rot.shape[1]
    dtype = X.rot.dtype

    rot_pad = jnp.concatenate(
        [X.rot, jnp.zeros((1, r, X.rot.shape[2]), dtype)]
    )
    trn_pad = jnp.concatenate([X.trn, jnp.zeros((1, r), dtype)])
    sph_pad = jnp.concatenate([X.sph, jnp.zeros((1, r), dtype)])

    out_rot = jnp.zeros((n_aug, r, X.rot.shape[2]), dtype)
    out_trn = jnp.zeros((t_aug, r), dtype)
    out_sph = jnp.zeros((l_aug, r), dtype)

    # ---- pose-pose ----
    if P.pp_ri.shape[0] > 0:
        kw = P.pp_kappa * P.pp_w * P.pp_active
        tw = P.pp_tau * P.pp_w * P.pp_active
        Yi = rot_pad[P.pp_ri]  # [m, r, d]
        Yj = rot_pad[P.pp_rj]
        ti = trn_pad[P.pp_ti]  # [m, r]
        tj = trn_pad[P.pp_tj]
        # s = Y_i t + t_i - t_j
        s = jnp.einsum("mrd,md->mr", Yi, P.pp_t) + ti - tj
        c_ri = kw[:, None, None] * (
            Yi - jnp.einsum("mre,mde->mrd", Yj, P.pp_R)
        ) + tw[:, None, None] * jnp.einsum("mr,md->mrd", s, P.pp_t)
        c_rj = kw[:, None, None] * (
            Yj - jnp.einsum("mre,med->mrd", Yi, P.pp_R)
        )
        out_rot = out_rot + _seg(
            jnp.concatenate([c_ri, c_rj]),
            jnp.concatenate([P.pp_ri, P.pp_rj]),
            n_aug + 1,
        )[:n_aug]
        tws = tw[:, None] * s
        out_trn = out_trn + _seg(
            jnp.concatenate([tws, -tws]),
            jnp.concatenate([P.pp_ti, P.pp_tj]),
            t_aug + 1,
        )[:t_aug]

    # ---- pose-landmark ----
    if P.pl_ri.shape[0] > 0:
        tw = P.pl_tau * P.pl_w * P.pl_active
        Yi = rot_pad[P.pl_ri]
        ti = trn_pad[P.pl_ti]
        tj = trn_pad[P.pl_tj]
        s = jnp.einsum("mrd,md->mr", Yi, P.pl_t) + ti - tj
        out_rot = out_rot + _seg(
            tw[:, None, None] * jnp.einsum("mr,md->mrd", s, P.pl_t),
            P.pl_ri,
            n_aug + 1,
        )[:n_aug]
        tws = tw[:, None] * s
        out_trn = out_trn + _seg(
            jnp.concatenate([tws, -tws]),
            jnp.concatenate([P.pl_ti, P.pl_tj]),
            t_aug + 1,
        )[:t_aug]

    # ---- ranges ----
    if P.rg_ti.shape[0] > 0:
        om = P.rg_prec * P.rg_w * P.rg_active
        ta = trn_pad[P.rg_ti]
        tb = trn_pad[P.rg_tj]
        sq = sph_pad[P.rg_q]
        g = P.rg_rho[:, None] * sq + tb - ta
        out_sph = out_sph + _seg(
            (om * P.rg_rho)[:, None] * g, P.rg_q, l_aug + 1
        )[:l_aug]
        omg = om[:, None] * g
        out_trn = out_trn + _seg(
            jnp.concatenate([-omg, omg]),
            jnp.concatenate([P.rg_ti, P.rg_tj]),
            t_aug + 1,
        )[:t_aug]

    # ---- prior quadratic diagonals (local slots only) ----
    if P.prior_kdiag is not None:
        n_loc = P.prior_kdiag.shape[0]
        kd = P.prior_kdiag.astype(dtype)
        out_rot = out_rot.at[:n_loc].add(kd[:, None, None] * X.rot[:n_loc])
    if P.prior_tdiag is not None:
        t_loc = P.prior_tdiag.shape[0]
        td = P.prior_tdiag.astype(dtype)
        out_trn = out_trn.at[:t_loc].add(td[:, None] * X.trn[:t_loc])

    return RAState(rot=out_rot, sph=out_sph, trn=out_trn)


def augment(X_local: RAState, X_fixed: Optional[RAState]) -> RAState:
    """Concatenate local and fixed-neighbor states into the augmented space."""
    if X_fixed is None:
        return X_local
    return RAState(
        rot=jnp.concatenate([X_local.rot, X_fixed.rot]),
        sph=jnp.concatenate([X_local.sph, X_fixed.sph]),
        trn=jnp.concatenate([X_local.trn, X_fixed.trn]),
    )


def restrict(X_aug: RAState, n: int, l: int, num_trans: int) -> RAState:  # noqa: E741
    """Slice the local block out of an augmented state."""
    return RAState(
        rot=X_aug.rot[:n], sph=X_aug.sph[:l], trn=X_aug.trn[:num_trans]
    )


def zeros_like_fixed(X_fixed: Optional[RAState]):
    if X_fixed is None:
        return None
    return jax.tree.map(jnp.zeros_like, X_fixed)


def linear_term(P: ProblemData, X_fixed: Optional[RAState],
                n: int, l: int, num_trans: int) -> RAState:  # noqa: E741
    """G = X_fixed^T Q_cb restricted to local slots, plus prior term.

    reference: constructLinearCostTermPGO/RASLAM (Graph.cpp:685-822,
    1190-1772) -- here a single apply_Q of the fixed-only state.
    X_fixed rank must match the working rank.
    """
    if X_fixed is not None:
        zeros_local = RAState(
            rot=jnp.zeros((n, X_fixed.rot.shape[1], X_fixed.rot.shape[2]),
                          X_fixed.rot.dtype),
            sph=jnp.zeros((l, X_fixed.sph.shape[1]), X_fixed.sph.dtype),
            trn=jnp.zeros((num_trans, X_fixed.trn.shape[1]),
                          X_fixed.trn.dtype),
        )
        G = restrict(apply_Q(P, augment(zeros_local, X_fixed)), n, l, num_trans)
    else:
        G = None
    if P.prior_G is not None:
        G = P.prior_G if G is None else G + P.prior_G
    return G


def cost(P: ProblemData, X: RAState, G: Optional[RAState] = None):
    """f(X) = 0.5 <XQ, X> + <X, G> (reference: QuadraticProblem.cpp:38-51).

    X is the LOCAL state when G is given (distributed subproblem), or the
    full/centralized state with G=None.
    """
    f = 0.5 * apply_Q(P, X).vdot(X)
    if G is not None:
        f = f + X.vdot(G)
    return f


def euclidean_gradient(P: ProblemData, X: RAState,
                       G: Optional[RAState] = None) -> RAState:
    """XQ + G (reference: QuadraticProblem.cpp:53-59)."""
    W = apply_Q(P, X)
    return W if G is None else W + G


def hessian_vec(P: ProblemData, V: RAState) -> RAState:
    """V Q (reference: QuadraticProblem.cpp:61-68).

    Uses the ELL fast path when available: V is a tangent vector, so the
    cancellation that rules ELL out for gradients does not arise here.
    """
    return apply_Q(P, V, prefer_ell=True)


# --------------------------------------------------------------------------
# Block-Jacobi preconditioner (matrix-free replacement for the reference's
# CHOLMOD Cholesky preconditioner, Graph.cpp:1901-1960 /
# QuadraticProblem.cpp:70-84): per-pose (d+1)x(d+1) diagonal blocks of Q in
# the SE-interleaved basis, scalar diagonals for spheres and landmarks.
# --------------------------------------------------------------------------


class Preconditioner(NamedTuple):
    pose_inv: jax.Array  # f64[n, d+1, d+1] explicit block inverses
    sph_diag: jax.Array  # f64[l]
    lmk_diag: jax.Array  # f64[b]


def build_preconditioner(P: ProblemData, n: int, l: int, b: int,  # noqa: E741
                         d: int, reg) -> Preconditioner:
    """Assemble and factor the block-diagonal of Q restricted to local slots.

    reg is the regularization term (reference rule: 1e-1 for PGO,
    lambda_max/(1e6-1) for RA-SLAM; Graph.cpp:1901-1960).
    """
    dh = d + 1
    blocks = jnp.zeros((n, dh, dh))
    lmk = jnp.zeros((b,))
    sph = jnp.zeros((l,))
    num_trans = n + b

    if P.pp_ri.shape[0] > 0:
        kw = P.pp_kappa * P.pp_w * P.pp_active
        tw = P.pp_tau * P.pp_w * P.pp_active
        t = P.pp_t
        # tail block: [[kw I + tw t tᵀ, tw t], [tw tᵀ, tw]]
        tail = jnp.zeros((t.shape[0], dh, dh))
        tail = tail.at[:, :d, :d].set(
            kw[:, None, None] * jnp.eye(d)
            + tw[:, None, None] * jnp.einsum("md,me->mde", t, t)
        )
        tail = tail.at[:, :d, d].set(tw[:, None] * t)
        tail = tail.at[:, d, :d].set(tw[:, None] * t)
        tail = tail.at[:, d, d].set(tw)
        # head block: [[kw I, 0], [0, tw]]
        head = jnp.zeros((t.shape[0], dh, dh))
        head = head.at[:, :d, :d].set(kw[:, None, None] * jnp.eye(d))
        head = head.at[:, d, d].set(tw)
        # scatter only into local pose slots (indices >= n drop out)
        contrib = jnp.concatenate([tail, head])
        idx = jnp.concatenate([P.pp_ri, P.pp_rj])
        idx = jnp.where(idx < n, idx, n)  # park fixed slots on a dump row
        blocks = blocks + _seg(contrib, idx, n + 1)[:n]

    if P.pl_ri.shape[0] > 0:
        tw = P.pl_tau * P.pl_w * P.pl_active
        t = P.pl_t
        tail = jnp.zeros((t.shape[0], dh, dh))
        tail = tail.at[:, :d, :d].set(
            tw[:, None, None] * jnp.einsum("md,me->mde", t, t)
        )
        tail = tail.at[:, :d, d].set(tw[:, None] * t)
        tail = tail.at[:, d, :d].set(tw[:, None] * t)
        tail = tail.at[:, d, d].set(tw)
        idx = jnp.where(P.pl_ri < n, P.pl_ri, n)
        blocks = blocks + _seg(tail, idx, n + 1)[:n]
        # landmark head diagonal
        jidx = P.pl_tj - n
        jidx = jnp.where((jidx >= 0) & (jidx < b), jidx, b)
        lmk = lmk + _seg(tw, jidx, b + 1)[:b]

    if P.rg_ti.shape[0] > 0:
        om = P.rg_prec * P.rg_w * P.rg_active
        qidx = jnp.where(P.rg_q < l, P.rg_q, l)
        sph = sph + _seg(om * P.rg_rho**2, qidx, l + 1)[:l]
        # translation diagonals (pose trans go into pose blocks' (d,d) entry)
        for tidx in (P.rg_ti, P.rg_tj):
            pose_idx = jnp.where(tidx < n, tidx, n)
            pose_add = _seg(om, pose_idx, n + 1)[:n]
            blocks = blocks.at[:, d, d].add(pose_add)
            lm = tidx - n
            lm = jnp.where((lm >= 0) & (lm < b), lm, b)
            lmk = lmk + _seg(om, lm, b + 1)[:b]

    if P.prior_kdiag is not None:
        blocks = blocks.at[:, jnp.arange(d), jnp.arange(d)].add(
            P.prior_kdiag[:, None]
        )
    if P.prior_tdiag is not None:
        blocks = blocks.at[:, d, d].add(P.prior_tdiag[:n])
        lmk = lmk + P.prior_tdiag[n:]

    blocks = blocks + reg * jnp.eye(dh)
    # explicit inverses: applying the preconditioner becomes one batched
    # small einsum per tCG iteration instead of two triangular solves
    # (the hot path), computed once through a Cholesky factorization.
    chol = jnp.linalg.cholesky(blocks)
    eye = jnp.broadcast_to(jnp.eye(dh, dtype=blocks.dtype), blocks.shape)
    inv = jax.scipy.linalg.cho_solve((chol, True), eye)
    return Preconditioner(
        pose_inv=inv, sph_diag=sph + reg, lmk_diag=lmk + reg
    )


def build_preconditioner_host(P: ProblemData, n: int, l: int,  # noqa: E741
                              b: int, d: int, reg) -> Preconditioner:
    """Numpy mirror of :func:`build_preconditioner` (same math, same dump
    slots), run entirely host-side.

    The jnp version compiles once per agent shape; the parallel problem
    build calls this once per agent on the host COO arrays instead (the reference's analogue is
    a host CHOLMOD factorization too, Graph.cpp:1901-1960)."""
    import numpy as np

    dh = d + 1
    a = np.asarray
    blocks = np.zeros((n, dh, dh))
    lmk = np.zeros((b,))
    sph = np.zeros((l,))

    if P.pp_ri.shape[0] > 0:
        kw = a(P.pp_kappa) * a(P.pp_w) * a(P.pp_active)
        tw = a(P.pp_tau) * a(P.pp_w) * a(P.pp_active)
        t = a(P.pp_t)
        m = t.shape[0]
        tail = np.zeros((m, dh, dh))
        tail[:, :d, :d] = (kw[:, None, None] * np.eye(d)
                           + tw[:, None, None] * t[:, :, None]
                           * t[:, None, :])
        tail[:, :d, d] = tw[:, None] * t
        tail[:, d, :d] = tw[:, None] * t
        tail[:, d, d] = tw
        head = np.zeros((m, dh, dh))
        head[:, :d, :d] = kw[:, None, None] * np.eye(d)
        head[:, d, d] = tw
        contrib = np.concatenate([tail, head])
        idx = np.concatenate([a(P.pp_ri), a(P.pp_rj)])
        ok = idx < n
        np.add.at(blocks, idx[ok], contrib[ok])

    if P.pl_ri.shape[0] > 0:
        tw = a(P.pl_tau) * a(P.pl_w) * a(P.pl_active)
        t = a(P.pl_t)
        m = t.shape[0]
        tail = np.zeros((m, dh, dh))
        tail[:, :d, :d] = tw[:, None, None] * t[:, :, None] * t[:, None, :]
        tail[:, :d, d] = tw[:, None] * t
        tail[:, d, :d] = tw[:, None] * t
        tail[:, d, d] = tw
        ri = a(P.pl_ri)
        ok = ri < n
        np.add.at(blocks, ri[ok], tail[ok])
        jidx = a(P.pl_tj) - n
        ok = (jidx >= 0) & (jidx < b)
        np.add.at(lmk, jidx[ok], tw[ok])

    if P.rg_ti.shape[0] > 0:
        om = a(P.rg_prec) * a(P.rg_w) * a(P.rg_active)
        q = a(P.rg_q)
        ok = q < l
        np.add.at(sph, q[ok], (om * a(P.rg_rho) ** 2)[ok])
        for tidx in (a(P.rg_ti), a(P.rg_tj)):
            ok = tidx < n
            np.add.at(blocks, (tidx[ok], d, d), om[ok])
            lm = tidx - n
            ok = (lm >= 0) & (lm < b)
            np.add.at(lmk, lm[ok], om[ok])

    if P.prior_kdiag is not None:
        kd = a(P.prior_kdiag)
        for i in range(d):
            blocks[:, i, i] += kd
    if P.prior_tdiag is not None:
        td = a(P.prior_tdiag)
        blocks[:, d, d] += td[:n]
        lmk += td[n:]

    blocks = blocks + reg * np.eye(dh)
    inv = np.linalg.inv(blocks)
    return Preconditioner(
        pose_inv=jnp.asarray(inv), sph_diag=jnp.asarray(sph + reg),
        lmk_diag=jnp.asarray(lmk + reg),
    )


def apply_preconditioner(M: Preconditioner, V: RAState) -> RAState:
    """Solve the block-diagonal system (reference: QuadraticProblem.cpp:70-84).

    Tangent projection is applied by the caller (as in the reference).
    """
    n = M.pose_inv.shape[0]
    b = M.lmk_diag.shape[0]
    # pack pose blocks [n, r, d+1] and right-multiply by the symmetric
    # block inverse
    pose_v = jnp.concatenate([V.rot, V.trn[:n, :, None]], axis=2)
    sol = jnp.einsum("nrd,nde->nre", pose_v, M.pose_inv)
    rot = sol[:, :, :-1]
    trn_pose = sol[:, :, -1]
    trn_lmk = V.trn[n:] / M.lmk_diag[:, None] if b else V.trn[n:]
    sph = V.sph / jnp.where(M.sph_diag == 0, 1.0, M.sph_diag)[:, None]
    return RAState(
        rot=rot, sph=sph, trn=jnp.concatenate([trn_pose, trn_lmk])
    )


def power_iteration_lambda_max(P: ProblemData, dims_probe: RAState,
                               iters: int = 50) -> jax.Array:
    """Estimate lambda_max(Q) by power iteration on apply_Q.

    Replaces the Spectra largest-eigenvalue solve used for RA-SLAM
    preconditioner regularization (Graph.cpp:1919-1960). dims_probe provides
    the shape/dtype of a state with r=1.
    """
    v0 = jax.tree.map(jnp.ones_like, dims_probe)
    nrm0 = v0.norm()
    v0 = v0.scale(1.0 / jnp.where(nrm0 == 0, 1.0, nrm0))

    def body(carry, _):
        v, lam = carry
        w = apply_Q(P, v)
        nrm = w.norm()
        lam = nrm
        w = w.scale(1.0 / jnp.where(nrm == 0, 1.0, nrm))
        return (w, lam), None

    (v, lam), _ = jax.lax.scan(body, (v0, jnp.zeros(())), None, length=iters)
    return lam
