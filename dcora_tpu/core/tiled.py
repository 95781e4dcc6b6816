"""Block-sparse tiled form of Q and the flat state layout.

This is the dense-tile path for the reference's two hottest loops -- the
tCG Hessian SpMM `V Q` (QuadraticProblem.cpp:61-68) and the Lanczos SpMVs
of certification (DCORA_utils.cpp:1807-1896):

  * Reordering the pose graph with reverse Cuthill-McKee collapses the
    scalar matrix Q into a narrow band, so Q partitions into a few hundred
    dense 128x128 tiles on city10000-class graphs.
  * The SpMM then becomes `gather X tiles -> batched matmul -> segment-sum
    into W tiles`, moving whole contiguous tiles instead of the ~20-byte
    per-edge rows that the gather paths of problem.py touch.

Layout contract
---------------
The flat state is one array  Xf in R^{r_pad x kpad}  over the *tiled scalar
ordering*: poses first (RCM order, interleaved [Y_i | p_i] like the
reference's SE layout, Elements.h:178), then unit spheres, then landmarks
(each section sorted by RCM rank), zero-padded to kpad = nt * T.  Zero rank
rows above the working rank stay zero under every op here, which preserves
the fixed-allocation Riemannian staircase of the RAState path.

Only *local* variables appear: measurement endpoints living on fixed
neighbor slots are dropped at build time (they belong to the linear term G,
which callers convert with :func:`to_flat`).

Numerics: the tiles multiply out the scalar entries of Q like the
reference's assembled sparse matrix (Graph.cpp:579-683), so applying them
costs the same ~6-digit cancellation near the optimum as the reference's
own `EucHessianEta`; pair the f32 tiles with an f64 refinement pass for
reference-precision results.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dcora_tpu.core.lifted import RAState
from dcora_tpu.core import problem as prob
from dcora_tpu.types import ProblemDims


def _tile_chunk() -> int:
    """Apply-time scan chunk (tiles per step).  Read in BOTH build_tiled
    (pre-padding) and apply_tiled so they always agree: a mismatch makes
    apply fall back to an in-program concatenate — the multi-GB
    per-Hessian-product copy the pre-pad exists to avoid at g2o100k
    scale."""
    return int(os.environ.get("DCORA_TILE_CHUNK", "2048"))


class TiledQ(NamedTuple):
    """Block-sparse Q over the tiled scalar ordering (device arrays)."""

    tiles: jax.Array       # f[m, T, T] dense tile data, sorted by tile_col
    tile_rows: jax.Array   # i32[m]
    tile_cols: jax.Array   # i32[m]
    # lane-permutation maps between RA scalar ordering and flat ordering
    ra_of_fl: jax.Array    # i32[kpad]; k points at an appended zero column
    fl_of_ra: jax.Array    # i32[k]


@dataclasses.dataclass(frozen=True)
class TiledMeta:
    """Static layout info (hashable; safe as a jit static argument)."""

    d: int
    n: int
    l: int  # noqa: E741
    b: int
    T: int
    nt: int

    @property
    def dh(self) -> int:
        return self.d + 1

    @property
    def k(self) -> int:
        return self.dh * self.n + self.l + self.b

    @property
    def kpad(self) -> int:
        return self.nt * self.T

    @property
    def pose_end(self) -> int:
        return self.dh * self.n

    @property
    def sph_end(self) -> int:
        return self.dh * self.n + self.l


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["Q", "pose_inv", "sph_inv", "lmk_inv", "diag_inv",
                 "btd_ltil", "btd_sinv"],
    meta_fields=["meta"],
)
@dataclasses.dataclass(frozen=True)
class TiledProblem:
    """Everything the flat solver needs on device.

    `meta` is static pytree metadata: passing a TiledProblem through jit
    retraces only when the layout (not the data) changes.
    """

    Q: TiledQ
    pose_inv: jax.Array      # f[dh, dh, n] block-Jacobi inverses, planar,
                             # RCM order: inv[c, e, i] = (B_i^-1)[c, e]
    sph_inv: jax.Array       # f[l]
    lmk_inv: jax.Array       # f[b]
    meta: TiledMeta = None
    # optional tile-granularity block-Jacobi: inverses of the regularized
    # T x T diagonal tiles of Q (RCM order packs graph neighborhoods into
    # tiles, so each block captures the coupling of a whole 128-column
    # window -- far stronger than the per-pose (d+1)-block Jacobi on
    # range-coupled problems, where the reference leans on a full CHOLMOD
    # factorization, Graph.cpp:1901-1917).  One batched [nt,T,T] matmul
    # per application.
    diag_inv: Optional[jax.Array] = None  # f[nt, T, T]
    # optional block-tridiagonal (RCM band) factorization M = (I+L~) S
    # (I+L~)^T of the regularized tridiagonal part of Q: L~_i = L_i
    # inv(S_{i-1}) with L_i the sub-diagonal tiles and S_i the safeguarded
    # Schur complements.  Captures ALL adjacent-tile coupling along the
    # RCM band -- the next rung toward the reference's full CHOLMOD factor
    # on range-coupled problems where the diagonal-tile Jacobi still
    # leaves tCG ill-conditioned (NOTES.md:33-37).  Application = two
    # length-nt lax.scans of [r_pad,T]@[T,T] matmuls + one batched solve.
    btd_ltil: Optional[jax.Array] = None  # f[nt, T, T] (L~_0 = 0)
    btd_sinv: Optional[jax.Array] = None  # f[nt, T, T]


# --------------------------------------------------------------------------
# Host-side build
# --------------------------------------------------------------------------


def _rcm_node_order(P: prob.ProblemData, dims: ProblemDims):
    """Reverse Cuthill-McKee over the variable graph (poses+spheres+lmks)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n, l, b = dims.n, dims.l, dims.b
    nn = n + l + b

    def node_of_trans(t):
        # translation index t: pose (t < n) or landmark
        return np.where(t < n, t, n + l + (t - n))

    ei, ej = [], []

    def add(a, b_, ok):
        ei.append(a[ok])
        ej.append(b_[ok])

    pp_i = np.asarray(P.pp_ri)
    pp_j = np.asarray(P.pp_rj)
    ok = (pp_i < n) & (pp_j < n)
    add(pp_i, pp_j, ok)

    pl_i = np.asarray(P.pl_ri)
    pl_j = np.asarray(P.pl_tj)
    ok = (pl_i < n) & (pl_j >= n) & (pl_j < n + b)
    add(pl_i, node_of_trans(pl_j), ok)

    rg_a = np.asarray(P.rg_ti)
    rg_b = np.asarray(P.rg_tj)
    rg_q = np.asarray(P.rg_q)
    ok_ab = (rg_a < n + b) & (rg_b < n + b)
    add(node_of_trans(rg_a), node_of_trans(rg_b), ok_ab)
    ok_q = (rg_q < l) & (rg_a < n + b)
    add(node_of_trans(rg_a), n + rg_q, ok_q)
    ok_q2 = (rg_q < l) & (rg_b < n + b)
    add(node_of_trans(rg_b), n + rg_q, ok_q2)

    if ei:
        ei = np.concatenate(ei)
        ej = np.concatenate(ej)
    else:
        ei = ej = np.zeros(0, np.int64)
    A = sp.coo_matrix((np.ones(len(ei)), (ei, ej)), shape=(nn, nn))
    order = reverse_cuthill_mckee((A + A.T).tocsr(), symmetric_mode=True)

    pose_rank = np.full(n, -1, np.int64)
    sph_rank = np.full(l, -1, np.int64)
    lmk_rank = np.full(b, -1, np.int64)
    pc = sc = lc = 0
    for node in order:
        if node < n:
            pose_rank[node] = pc
            pc += 1
        elif node < n + l:
            sph_rank[node - n] = sc
            sc += 1
        else:
            lmk_rank[node - n - l] = lc
            lc += 1
    return pose_rank, sph_rank, lmk_rank


def _scalar_maps(dims: ProblemDims, pose_rank, sph_rank, lmk_rank,
                 n_aug_pose: int, t_aug: int, l_aug: int):
    """Lookup arrays from augmented endpoint indices to flat scalar columns.

    -1 marks fixed-neighbor slots (dropped: their coupling lives in G).
    Returns (rot_base[n_aug_pose], trn_col[t_aug], sph_col[l_aug]).
    """
    n, l, b, dh = dims.n, dims.l, dims.b, dims.d + 1
    rot_base = np.full(max(n_aug_pose, 1), -1, np.int64)
    rot_base[:n] = pose_rank * dh
    trn_col = np.full(max(t_aug, 1), -1, np.int64)
    trn_col[:n] = pose_rank * dh + dims.d
    if b:
        trn_col[n:n + b] = n * dh + l + lmk_rank
    sph_col = np.full(max(l_aug, 1), -1, np.int64)
    if l:
        sph_col[:l] = n * dh + sph_rank
    return rot_base, trn_col, sph_col


def _scalar_coo(P: prob.ProblemData, dims: ProblemDims,
                rot_base, trn_col, sph_col):
    """Emit the scalar COO of the local Q in the flat ordering.

    Mirrors the closed-form per-edge blocks of problem.build_ell /
    Graph.cpp:579-683,824-1188; entries whose row or column maps to -1
    (fixed neighbor slots) are dropped.
    """
    d = dims.d
    rows_all, cols_all, vals_all = [], [], []
    ar = np.arange(d)

    def emit(r_, c_, v):
        r_, c_, v = np.broadcast_arrays(r_, c_, v)
        ok = (r_ >= 0) & (c_ >= 0)
        rows_all.append(r_[ok].ravel())
        cols_all.append(c_[ok].ravel())
        vals_all.append(v[ok].ravel())

    def col_or_neg(base, idx):
        return np.where(idx < len(base), base[np.minimum(idx, len(base) - 1)],
                        -1)

    mpp = int(P.pp_ri.shape[0])
    if mpp:
        ri = col_or_neg(rot_base, np.asarray(P.pp_ri))
        rj = col_or_neg(rot_base, np.asarray(P.pp_rj))
        Ti = col_or_neg(trn_col, np.asarray(P.pp_ti))
        Tj = col_or_neg(trn_col, np.asarray(P.pp_tj))
        R = np.asarray(P.pp_R)
        t = np.asarray(P.pp_t)
        w = np.asarray(P.pp_w) * np.asarray(P.pp_active)
        kw = np.asarray(P.pp_kappa) * w
        tw = np.asarray(P.pp_tau) * w
        Ri = np.where(ri[:, None] >= 0, ri[:, None] + ar, -1)
        Rj = np.where(rj[:, None] >= 0, rj[:, None] + ar, -1)
        eye = np.eye(d)
        emit(Ri[:, :, None], Ri[:, None, :],
             kw[:, None, None] * eye
             + tw[:, None, None] * t[:, :, None] * t[:, None, :])
        emit(Rj, Rj, np.broadcast_to(kw[:, None], (mpp, d)))
        V = -kw[:, None, None] * R
        emit(Ri[:, :, None], Rj[:, None, :], V)
        emit(Rj[:, None, :], Ri[:, :, None], V)
        v = tw[:, None] * t
        emit(Ri, Ti[:, None], v)
        emit(Ti[:, None], Ri, v)
        emit(Ri, Tj[:, None], -v)
        emit(Tj[:, None], Ri, -v)
        emit(Ti, Ti, tw)
        emit(Tj, Tj, tw)
        emit(Ti, Tj, -tw)
        emit(Tj, Ti, -tw)

    mpl = int(P.pl_ri.shape[0])
    if mpl:
        ri = col_or_neg(rot_base, np.asarray(P.pl_ri))
        Ti = col_or_neg(trn_col, np.asarray(P.pl_ti))
        Tj = col_or_neg(trn_col, np.asarray(P.pl_tj))
        t = np.asarray(P.pl_t)
        tw = np.asarray(P.pl_tau) * np.asarray(P.pl_w) * \
            np.asarray(P.pl_active)
        Ri = np.where(ri[:, None] >= 0, ri[:, None] + ar, -1)
        emit(Ri[:, :, None], Ri[:, None, :],
             tw[:, None, None] * t[:, :, None] * t[:, None, :])
        v = tw[:, None] * t
        emit(Ri, Ti[:, None], v)
        emit(Ti[:, None], Ri, v)
        emit(Ri, Tj[:, None], -v)
        emit(Tj[:, None], Ri, -v)
        emit(Ti, Ti, tw)
        emit(Tj, Tj, tw)
        emit(Ti, Tj, -tw)
        emit(Tj, Ti, -tw)

    mrg = int(P.rg_ti.shape[0])
    if mrg:
        Ta = col_or_neg(trn_col, np.asarray(P.rg_ti))
        Tb = col_or_neg(trn_col, np.asarray(P.rg_tj))
        Sq = col_or_neg(sph_col, np.asarray(P.rg_q))
        rho = np.asarray(P.rg_rho)
        om = np.asarray(P.rg_prec) * np.asarray(P.rg_w) * \
            np.asarray(P.rg_active)
        emit(Sq, Sq, om * rho * rho)
        emit(Sq, Ta, -om * rho)
        emit(Ta, Sq, -om * rho)
        emit(Sq, Tb, om * rho)
        emit(Tb, Sq, om * rho)
        emit(Ta, Ta, om)
        emit(Tb, Tb, om)
        emit(Ta, Tb, -om)
        emit(Tb, Ta, -om)

    if P.prior_kdiag is not None:
        kd = np.asarray(P.prior_kdiag)
        base = rot_base[:dims.n]
        Ri = np.where(base[:, None] >= 0, base[:, None] + ar, -1)
        emit(Ri, Ri, np.broadcast_to(kd[:, None], (dims.n, d)))
    if P.prior_tdiag is not None:
        td = np.asarray(P.prior_tdiag)
        Ti = trn_col[:dims.num_trans]
        emit(Ti, Ti, td)

    if rows_all:
        return (np.concatenate(rows_all), np.concatenate(cols_all),
                np.concatenate(vals_all))
    return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))


def build_tiled(P: prob.ProblemData, dims: ProblemDims, T: int = 128,
                dtype=np.float32,
                precond: Optional[prob.Preconditioner] = None,
                reg: float = 0.1,
                tile_precond: bool = False,
                as_numpy: bool = False) -> TiledProblem:
    """Host-side: RCM order, tile the scalar Q, invert the Jacobi blocks.

    `dtype` selects the tile precision (f32 for the coarse phase; f64 for
    exact oracles / the refinement phase).  `precond` reuses an existing
    block-Jacobi factorization; otherwise one is built with regularization
    `reg` (reference PGO value 0.1, Graph.cpp:1901-1917).
    """
    # as_numpy keeps every leaf a host numpy array: the fleet builder
    # (parallel.rbcd._build_tiled_batched) pads and stacks per-agent
    # problems on the host and ships ONE [A, ...] transfer per leaf
    # instead of A small ones
    conv = (lambda a: a) if as_numpy else jnp.asarray
    n, l, b, d = dims.n, dims.l, dims.b, dims.d
    dh = d + 1
    pose_rank, sph_rank, lmk_rank = _rcm_node_order(P, dims)

    def amax(a):
        return int(np.asarray(a).max(initial=-1)) + 1

    n_aug_pose = max(n, amax(P.pp_ri), amax(P.pp_rj), amax(P.pl_ri))
    t_aug = max(dims.num_trans, amax(P.pp_ti), amax(P.pp_tj),
                amax(P.pl_ti), amax(P.pl_tj), amax(P.rg_ti), amax(P.rg_tj))
    l_aug = max(l, amax(P.rg_q))

    rot_base, trn_col, sph_col = _scalar_maps(
        dims, pose_rank, sph_rank, lmk_rank, n_aug_pose, t_aug, l_aug)
    rows, cols, vals = _scalar_coo(P, dims, rot_base, trn_col, sph_col)

    k = dh * n + l + b
    nt = max(-(-k // T), 1)
    kpad = nt * T

    # Fill dense tiles straight from the raw COO with one bincount:
    # duplicate scalar entries accumulate in the bincount itself, so the
    # former scipy coo->csr->sum_duplicates->coo round-trip (~0.6 s per
    # city10000-sized agent) is unnecessary, and bincount is ~6x faster
    # than np.add.at for the fill (measured 1.33 s -> 0.2 s).
    tr = (rows // T).astype(np.int64)
    tc = (cols // T).astype(np.int64)
    keys, inv = np.unique(tr * nt + tc, return_inverse=True)
    trow = (keys // nt).astype(np.int32)
    tcol = (keys % nt).astype(np.int32)
    ntiles = max(len(keys), 1)
    if len(keys):
        flat = inv * (T * T) + (rows - tr * T) * T + (cols - tc * T)
        dense = np.bincount(
            flat, weights=vals, minlength=ntiles * T * T
        ).reshape(ntiles, T, T)
    else:
        dense = np.zeros((ntiles, T, T), np.float64)
        trow = np.zeros(1, np.int32)
        tcol = np.zeros(1, np.int32)
    # sort by output tile (column) for a cheap segment-sum
    order = np.argsort(tcol, kind="stable")
    dense, trow, tcol = dense[order], trow[order], tcol[order]

    # scalar ordering maps (RA ordering as in problem._apply_ell:
    # rot (i,a) -> i*d + a, spheres, then translations)
    fl_of_ra = np.empty(k, np.int64)
    fl_of_ra[:n * d] = pose_rank[np.arange(n * d) // d] * dh + \
        (np.arange(n * d) % d)
    if l:
        fl_of_ra[n * d:n * d + l] = n * dh + sph_rank
    fl_of_ra[n * d + l:n * d + l + n] = pose_rank * dh + d
    if b:
        fl_of_ra[n * d + l + n:] = n * dh + l + lmk_rank
    ra_of_fl = np.full(kpad, k, np.int64)
    ra_of_fl[fl_of_ra] = np.arange(k)

    meta = TiledMeta(d=d, n=n, l=l, b=b, T=T, nt=nt)
    # Pad the tile list to a multiple of the apply-time chunk so the
    # scan-chunked SpMM can reshape in place: padding inside apply would
    # concatenate-copy the full tile array (3.6 GB at g2o100k/f64) on
    # EVERY Hessian product and exhaust device memory.  Zero tiles
    # accumulate nothing into tile (0, 0).  The BTD/diag preconditioner
    # extraction above uses the unpadded arrays.
    _CH = _tile_chunk()
    if len(trow) > _CH and len(trow) % _CH:
        padm = _CH - len(trow) % _CH
        dense_q = np.concatenate(
            [dense, np.zeros((padm,) + dense.shape[1:], dense.dtype)])
        trow_q = np.concatenate([trow, np.zeros(padm, np.int32)])
        tcol_q = np.concatenate([tcol, np.zeros(padm, np.int32)])
    else:
        dense_q, trow_q, tcol_q = dense, trow, tcol
    Q = TiledQ(
        tiles=conv(dense_q.astype(dtype, copy=False)),
        tile_rows=conv(trow_q),
        tile_cols=conv(tcol_q),
        ra_of_fl=conv(ra_of_fl.astype(np.int32)),
        fl_of_ra=conv(fl_of_ra.astype(np.int32)),
    )

    # block-Jacobi preconditioner in flat (RCM) order.  The blocks are the
    # diagonal (dh x dh) pose blocks and sphere/landmark scalars of the very
    # COO assembled above, so extract them host-side (numpy) instead of
    # re-assembling them on device with prob.build_preconditioner.
    if precond is not None:
        perm = np.argsort(pose_rank)  # original pose index at each RCM slot
        pose_inv = conv(
            np.ascontiguousarray(np.asarray(precond.pose_inv)[perm]
                                 .transpose(1, 2, 0)).astype(dtype))
        sph_d = np.asarray(precond.sph_diag)
        lmk_d = np.asarray(precond.lmk_diag)
        sph_inv = np.zeros(max(l, 0))
        lmk_inv = np.zeros(max(b, 0))
        if l:
            sph_inv[sph_rank] = 1.0 / np.where(sph_d == 0, 1.0, sph_d)
        if b:
            lmk_inv[lmk_rank] = 1.0 / np.where(lmk_d == 0, 1.0, lmk_d)
    else:
        # accumulate the diagonal (dh x dh) pose blocks straight from the
        # raw COO (scipy fancy indexing on CSR is ~1000x slower)
        pose_blocks = np.zeros((n, dh, dh))
        in_pose = (rows < n * dh) & (rows // dh == cols // dh)
        np.add.at(
            pose_blocks,
            (rows[in_pose] // dh, rows[in_pose] % dh, cols[in_pose] % dh),
            vals[in_pose],
        )
        pose_blocks = pose_blocks + reg * np.eye(dh)
        pose_inv = conv(np.ascontiguousarray(
            np.linalg.inv(pose_blocks).transpose(1, 2, 0)).astype(dtype))
        tail_diag = np.zeros(max(l + b, 1))
        on_tail = (rows >= n * dh) & (rows == cols)
        np.add.at(tail_diag, rows[on_tail] - n * dh, vals[on_tail])
        sph_inv = np.zeros(max(l, 0))
        lmk_inv = np.zeros(max(b, 0))
        if l:
            sd = tail_diag[:l] + reg
            sph_inv[:] = 1.0 / np.where(sd == 0, 1.0, sd)
        if b:
            ld = tail_diag[l:l + b] + reg
            lmk_inv[:] = 1.0 / np.where(ld == 0, 1.0, ld)
    diag_inv = btd_ltil = btd_sinv = None
    if tile_precond == "btd":
        btd_ltil, btd_sinv = _factor_btd(dense, trow, tcol, nt, T, reg,
                                         dtype, conv=conv)
    elif tile_precond:
        # tile-granularity block-Jacobi: invert the regularized T x T
        # diagonal tiles (f64 inversion, stored at the tile dtype).
        # Padding rows >= k get reg on the diagonal, keeping blocks SPD.
        diag_blocks = np.zeros((nt, T, T))
        on_diag = trow == tcol
        diag_blocks[trow[on_diag]] = dense[on_diag]
        diag_blocks += reg * np.eye(T)
        diag_inv = conv(np.linalg.inv(diag_blocks).astype(dtype))
    return TiledProblem(
        Q=Q, meta=meta,
        pose_inv=pose_inv,
        sph_inv=conv(sph_inv.astype(dtype)),
        lmk_inv=conv(lmk_inv.astype(dtype)),
        diag_inv=diag_inv,
        btd_ltil=btd_ltil,
        btd_sinv=btd_sinv,
    )


def _factor_btd(dense, trow, tcol, nt: int, T: int, reg: float, dtype,
                conv=jnp.asarray):
    """Block-LDL^T of the regularized block-tridiagonal part of Q.

    M = (I + L~) S (I + L~)^T with L~_i = L_i inv(S_{i-1}) and
    S_i = D_i + reg I - L_i inv(S_{i-1}) L_i^T.  The tridiagonal
    truncation of an SPD matrix need not be SPD, so each Schur complement
    is safeguarded: if its smallest eigenvalue falls below 0.5*reg the
    block is shifted up to that floor (any SPD M is a valid tCG
    preconditioner; the safeguard only weakens it locally).  Returns
    (L~ f[nt,T,T] with L~_0 = 0, inv(S) f[nt,T,T]) at the tile dtype.
    """
    D = np.zeros((nt, T, T))
    on_diag = trow == tcol
    D[trow[on_diag]] = dense[on_diag]
    D += reg * np.eye(T)
    L = np.zeros((nt, T, T))  # L[i] = tile(i, i-1), i >= 1
    on_sub = trow == tcol + 1
    L[trow[on_sub]] = dense[on_sub]

    floor = 0.5 * reg
    Sinv = np.zeros((nt, T, T))
    Ltil = np.zeros((nt, T, T))
    Sprev_inv = None
    for i in range(nt):
        Si = D[i].copy()
        if i > 0 and L[i].any():
            Ltil[i] = L[i] @ Sprev_inv
            Si -= Ltil[i] @ L[i].T
        # safeguard: keep every Schur complement decisively SPD
        w = np.linalg.eigvalsh(0.5 * (Si + Si.T))
        if w[0] < floor:
            Si += (floor - w[0]) * np.eye(T)
        Sinv[i] = np.linalg.inv(0.5 * (Si + Si.T))
        Sprev_inv = Sinv[i]
    return (conv(Ltil.astype(dtype)), conv(Sinv.astype(dtype)))


# --------------------------------------------------------------------------
# Device ops (all shapes static; n in the lane dimension throughout)
# --------------------------------------------------------------------------


def apply_tiled(TP: TiledProblem, Xf: jax.Array) -> jax.Array:
    """W = Xf Q (symmetric Q):  [r_pad, kpad] -> [r_pad, kpad].

    gather X tiles -> batched matmul -> segment-sum into W tiles.
    """
    meta = TP.meta
    r_pad = Xf.shape[0]
    Xt = Xf.reshape(r_pad, meta.nt, meta.T).transpose(1, 0, 2)  # [nt, r, T]
    m = int(TP.Q.tiles.shape[0])
    CH = _tile_chunk()
    if m <= CH:
        Xg = Xt[TP.Q.tile_rows]                                 # [m, r, T]
        Yg = jax.lax.dot_general(
            Xg, TP.Q.tiles.astype(Xf.dtype),
            (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=Xf.dtype,
        )
        W = jax.ops.segment_sum(Yg, TP.Q.tile_cols, num_segments=meta.nt)
    else:
        # Chunk the tile axis: one unchunked batched dot at g2o100k scale
        # (29k tiles) lets XLA materialize an [r, m, T, T] temp (14 GB);
        # a scan over fixed-size chunks bounds every temp at CH tiles
        # while touching the same bytes once.
        mp = -(-m // CH) * CH
        pad = mp - m
        if pad:
            # small/test problems only: build_tiled pre-pads to the
            # default chunk, so the large-problem path reshapes in place
            # (a concatenate here would copy the full tile array inside
            # the program on every Hessian product)
            tiles_p = jnp.concatenate([
                TP.Q.tiles.astype(Xf.dtype),
                jnp.zeros((pad,) + TP.Q.tiles.shape[1:], Xf.dtype)])
            rows_p = jnp.concatenate(
                [TP.Q.tile_rows, jnp.zeros(pad, jnp.int32)])
            cols_p = jnp.concatenate(
                [TP.Q.tile_cols, jnp.zeros(pad, jnp.int32)])
        else:
            tiles_p = TP.Q.tiles.astype(Xf.dtype)
            rows_p = TP.Q.tile_rows
            cols_p = TP.Q.tile_cols
        tiles_c = tiles_p.reshape(mp // CH, CH, meta.T, meta.T)
        rows_c = rows_p.reshape(mp // CH, CH)
        cols_c = cols_p.reshape(mp // CH, CH)
        # padding tiles are all-zero: they add nothing to segment 0

        def step(W, chunk):
            t_c, r_c, c_c = chunk
            Xg = Xt[r_c]                                       # [CH, r, T]
            Yg = jax.lax.dot_general(
                Xg, t_c, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=Xf.dtype,
            )
            return W + jax.ops.segment_sum(
                Yg, c_c, num_segments=meta.nt), None

        W0 = jnp.zeros((meta.nt, r_pad, meta.T), Xf.dtype)
        W, _ = jax.lax.scan(step, W0, (tiles_c, rows_c, cols_c))
    return W.transpose(1, 0, 2).reshape(r_pad, meta.kpad)


def to_flat(TP: TiledProblem, X: RAState, r_pad: Optional[int] = None
            ) -> jax.Array:
    """RAState -> flat [r_pad, kpad] (tiled ordering)."""
    from dcora_tpu.core import lifted

    ra = lifted.to_flat(X)  # [r, k]
    if r_pad is not None and r_pad > ra.shape[0]:
        ra = jnp.pad(ra, ((0, r_pad - ra.shape[0]), (0, 0)))
    zero = jnp.zeros((ra.shape[0], 1), ra.dtype)
    return jnp.concatenate([ra, zero], axis=1)[:, TP.Q.ra_of_fl]


def from_flat(TP: TiledProblem, Xf: jax.Array, r: Optional[int] = None
              ) -> RAState:
    """Flat [r_pad, kpad] -> RAState (optionally truncating rank rows)."""
    from dcora_tpu.core import lifted

    ra = Xf[:, TP.Q.fl_of_ra]
    if r is not None:
        ra = ra[:r]
    return lifted.from_flat(ra, ProblemDims(TP.meta.d, TP.meta.n,
                                            TP.meta.l, TP.meta.b))


def _pose3(meta: TiledMeta, Xf: jax.Array) -> jax.Array:
    """[r, n, dh] view of the pose section."""
    return Xf[:, :meta.pose_end].reshape(Xf.shape[0], meta.n, meta.dh)


def _sections(meta: TiledMeta, Xf: jax.Array):
    pose = _pose3(meta, Xf)
    sph = Xf[:, meta.pose_end:meta.sph_end]
    tail = Xf[:, meta.sph_end:]  # landmarks + padding
    return pose, sph, tail


def _join(meta: TiledMeta, pose, sph, tail) -> jax.Array:
    r_pad = pose.shape[0]
    return jnp.concatenate(
        [pose.reshape(r_pad, meta.pose_end), sph, tail], axis=1
    )


def _planar_cols(meta: TiledMeta, Xf: jax.Array):
    """The dh per-pose component slices as lane-major [r_pad, n] arrays.

    An einsum over the [r, n, dh] view lowers to dot_general, which breaks
    XLA fusion and materializes rank-3 intermediates with a size-dh minor
    dimension.  Everything in the tCG hot loop therefore stays on 2-D
    [r_pad, n] slices and unrolled static loops over the tiny d x d
    indices, which fuse into elementwise kernels.
    """
    P3 = _pose3(meta, Xf).transpose(0, 2, 1)  # [r, dh, n] (copy, fusible)
    return [P3[:, c] for c in range(meta.dh)]


def _join_cols(meta: TiledMeta, cols, sph, tail) -> jax.Array:
    pose = jnp.stack(cols, axis=2)  # [r, n, dh]
    return _join(meta, pose, sph, tail)


def tangent_project_flat(meta: TiledMeta, Xf: jax.Array,
                         Vf: jax.Array) -> jax.Array:
    """V - Y sym(Y^T V) on Stiefel blocks; sphere de-projection; id on R.

    Flat-layout equivalent of manifold.tangent_project
    (reference: DCORA_utils.cpp:2033-2051).
    """
    Xc = _planar_cols(meta, Xf)
    Vc = _planar_cols(meta, Vf)
    d = meta.d
    _, Xs, _ = _sections(meta, Xf)
    _, Vs, Vt = _sections(meta, Vf)
    # S[a][b] = sum_rho Y_a Y'_b  as [n] vectors
    S = [[jnp.sum(Xc[a] * Vc[b], axis=0) for b in range(d)]
         for a in range(d)]
    rot = []
    for a in range(d):
        acc = Vc[a]
        for b in range(d):
            acc = acc - Xc[b] * (0.5 * (S[b][a] + S[a][b]))[None, :]
        rot.append(acc)
    if meta.l:
        inner = jnp.sum(Xs * Vs, axis=0, keepdims=True)
        sph = Vs - Xs * inner
    else:
        sph = Vs
    return _join_cols(meta, rot + [Vc[d]], sph, Vt)


def weingarten_setup(meta: TiledMeta, Xf: jax.Array, egrad: jax.Array):
    """Constants of the Weingarten map for a fixed egrad: Ssym[a][b] =
    sym(Y^T egrad)[a,b] as [n] vectors plus the sphere inner products.
    egrad does not change during a tCG solve, so this runs once per outer
    iteration (cf. the RA backend hess_setup in rtr.py)."""
    Xc = _planar_cols(meta, Xf)
    Gc = _planar_cols(meta, egrad)
    d = meta.d
    S = [[jnp.sum(Xc[a] * Gc[b], axis=0) for b in range(d)]
         for a in range(d)]
    Ssym = [[0.5 * (S[b][a] + S[a][b]) for b in range(d)] for a in range(d)]
    if meta.l:
        _, Xs, _ = _sections(meta, Xf)
        _, Gs, _ = _sections(meta, egrad)
        s_inner = jnp.sum(Xs * Gs, axis=0, keepdims=True)
    else:
        s_inner = None
    return (Ssym, s_inner)


def weingarten_apply(meta: TiledMeta, eta: jax.Array, aux) -> jax.Array:
    """Apply the precomputed Weingarten constants to a tangent vector."""
    Ssym, s_inner = aux
    Ec = _planar_cols(meta, eta)
    d = meta.d
    _, Es, Et = _sections(meta, eta)
    rot = []
    for a in range(d):
        acc = Ec[0] * Ssym[a][0][None, :]
        for b in range(1, d):
            acc = acc + Ec[b] * Ssym[a][b][None, :]
        rot.append(acc)
    if meta.l:
        sph = Es * s_inner
    else:
        sph = Es
    return _join_cols(meta, rot + [jnp.zeros_like(Ec[d])], sph,
                      jnp.zeros_like(Et))


def _precondition_tiles(TP: TiledProblem, Vf: jax.Array) -> jax.Array:
    """Tile-granularity block-Jacobi: one batched [nt, T, T] solve."""
    meta = TP.meta
    r_pad = Vf.shape[0]
    V3 = Vf.reshape(r_pad, meta.nt, meta.T)
    inv = TP.diag_inv.astype(Vf.dtype)
    W = jnp.einsum("rct,cts->rcs", V3, inv)
    return W.reshape(r_pad, meta.kpad)


def _precondition_btd(TP: TiledProblem, Vf: jax.Array) -> jax.Array:
    """Block-tridiagonal solve M^{-1} v along the RCM band.

    Row-vector form of the block-LDL^T solve (M = (I+L~) S (I+L~)^T,
    see _factor_btd): forward substitution u_i = v_i - u_{i-1} L~_i^T,
    batched diagonal solve w_i = u_i Sinv_i, backward substitution
    y_i = w_i - y_{i+1} L~_{i+1}.  Two length-nt lax.scans of
    [r_pad, T] @ [T, T] matmuls -- sequential along the band, but the
    band is exactly what the diagonal-tile Jacobi cannot capture.
    """
    meta = TP.meta
    r_pad = Vf.shape[0]
    V3 = Vf.reshape(r_pad, meta.nt, meta.T).transpose(1, 0, 2)  # [nt,r,T]
    Ltil = TP.btd_ltil.astype(Vf.dtype)
    Sinv = TP.btd_sinv.astype(Vf.dtype)

    def fwd(u_prev, inp):
        v, Lt = inp
        u = v - jax.lax.dot_general(
            u_prev, Lt, (((1,), (1,)), ((), ())),
            preferred_element_type=Vf.dtype,
        )  # u_prev @ Lt^T
        return u, u

    _, U = jax.lax.scan(fwd, jnp.zeros_like(V3[0]), (V3, Ltil))
    W = jnp.einsum("nrt,nts->nrs", U, Sinv)
    Ltil_next = jnp.concatenate([Ltil[1:], jnp.zeros_like(Ltil[:1])])

    def bwd(y_next, inp):
        w, Ln = inp
        y = w - jnp.matmul(y_next, Ln)
        return y, y

    _, Y = jax.lax.scan(bwd, jnp.zeros_like(W[0]), (W, Ltil_next),
                        reverse=True)
    return Y.transpose(1, 0, 2).reshape(r_pad, meta.kpad)


def precondition_flat(TP: TiledProblem, Vf: jax.Array) -> jax.Array:
    """Block-Jacobi solve in flat layout (cf. prob.apply_preconditioner).

    With TP.btd_ltil present the solve is block-tridiagonal along the
    RCM band; with TP.diag_inv present it runs at tile granularity;
    otherwise TP.pose_inv is stored planar [dh, dh, n] so the application
    is dh^2 lane-parallel multiply-adds.
    """
    if TP.btd_ltil is not None:
        return _precondition_btd(TP, Vf)
    if TP.diag_inv is not None:
        return _precondition_tiles(TP, Vf)
    meta = TP.meta
    dh = meta.dh
    Vc = _planar_cols(meta, Vf)
    _, Vs, Vt = _sections(meta, Vf)
    inv = TP.pose_inv.astype(Vf.dtype)
    out = []
    for e in range(dh):
        acc = Vc[0] * inv[0, e][None, :]
        for c in range(1, dh):
            acc = acc + Vc[c] * inv[c, e][None, :]
        out.append(acc)
    if meta.l:
        sph = Vs * TP.sph_inv.astype(Vf.dtype)[None, :]
    else:
        sph = Vs
    if meta.b:
        lmk = Vt[:, :meta.b] * TP.lmk_inv.astype(Vf.dtype)[None, :]
        tail = jnp.concatenate([lmk, Vt[:, meta.b:]], axis=1)
    else:
        tail = Vt
    return _join_cols(meta, out, sph, tail)


def retract_flat(meta: TiledMeta, Xf: jax.Array, Vf: jax.Array) -> jax.Array:
    """Polar retraction on Stiefel blocks, normalize spheres, add elsewhere."""
    from dcora_tpu.core.manifold import _inv_sqrt_psd

    Xp, Xs, Xt = _sections(meta, Xf)
    Vp, Vs, Vt = _sections(meta, Vf)
    d = meta.d
    A = Xp[:, :, :d] + Vp[:, :, :d]                 # [r, n, d]
    Gm = jnp.einsum("rna,rnb->nab", A, A)           # [n, d, d]
    rot = jnp.einsum("rnb,nba->rna", A, _inv_sqrt_psd(Gm))
    pose = jnp.concatenate([rot, Xp[:, :, d:] + Vp[:, :, d:]], axis=2)
    if meta.l:
        S = Xs + Vs
        nrm = jnp.linalg.norm(S, axis=0, keepdims=True)
        sph = S / jnp.where(nrm == 0, 1.0, nrm)
    else:
        sph = Xs + Vs
    return _join(meta, pose, sph, Xt + Vt)


# --------------------------------------------------------------------------
# Planar tCG representation
#
# The flat [r_pad, kpad] layout interleaves pose components (lane i*dh+c),
# so every per-pose manifold op pays two [r, n, dh] <-> [r, dh, n]
# relayouts (_planar_cols/_join_cols).  The tCG state is therefore kept
# *planar* -- a pytree of dh [r_pad, n] component slices plus the
# sphere/tail sections -- where every manifold op is straight-line
# fusible elementwise arithmetic, and the interleaved layout is
# materialized only at the SpMM boundary (2 relayouts per Hessian product
# instead of ~8 per inner iteration).
# --------------------------------------------------------------------------


class Planar(NamedTuple):
    """tCG state/vector in component-major (planar) layout."""

    pose: tuple           # dh arrays f[r_pad, n] (components 0..d rot, d trn)
    sph: jax.Array        # f[r_pad, l]
    tail: jax.Array       # f[r_pad, kpad - sph_end] (landmarks + padding)


def to_planar(meta: TiledMeta, Xf: jax.Array) -> Planar:
    """Flat [r_pad, kpad] -> Planar (one relayout of the pose section)."""
    P3 = _pose3(meta, Xf).transpose(0, 2, 1)  # [r, dh, n]
    _, sph, tail = _sections(meta, Xf)
    return Planar(pose=tuple(P3[:, c] for c in range(meta.dh)),
                  sph=sph, tail=tail)


def from_planar(meta: TiledMeta, Xp: Planar) -> jax.Array:
    """Planar -> flat [r_pad, kpad] (one relayout of the pose section)."""
    return _join_cols(meta, list(Xp.pose), Xp.sph, Xp.tail)


def tangent_project_planar(meta: TiledMeta, Xp: Planar,
                           Vp: Planar) -> Planar:
    """V - Y sym(Y^T V) on Stiefel blocks; sphere de-projection; id on R."""
    d = meta.d
    S = [[jnp.sum(Xp.pose[a] * Vp.pose[b], axis=0) for b in range(d)]
         for a in range(d)]
    rot = []
    for a in range(d):
        acc = Vp.pose[a]
        for b in range(d):
            acc = acc - Xp.pose[b] * (0.5 * (S[b][a] + S[a][b]))[None, :]
        rot.append(acc)
    if meta.l:
        inner = jnp.sum(Xp.sph * Vp.sph, axis=0, keepdims=True)
        sph = Vp.sph - Xp.sph * inner
    else:
        sph = Vp.sph
    return Planar(pose=tuple(rot + [Vp.pose[d]]), sph=sph, tail=Vp.tail)


def weingarten_setup_planar(meta: TiledMeta, Xp: Planar, egrad: Planar):
    d = meta.d
    S = [[jnp.sum(Xp.pose[a] * egrad.pose[b], axis=0) for b in range(d)]
         for a in range(d)]
    Ssym = [[0.5 * (S[b][a] + S[a][b]) for b in range(d)] for a in range(d)]
    if meta.l:
        s_inner = jnp.sum(Xp.sph * egrad.sph, axis=0, keepdims=True)
    else:
        s_inner = None
    return (Ssym, s_inner)


def weingarten_apply_planar(meta: TiledMeta, eta: Planar, aux) -> Planar:
    Ssym, s_inner = aux
    d = meta.d
    rot = []
    for a in range(d):
        acc = eta.pose[0] * Ssym[a][0][None, :]
        for b in range(1, d):
            acc = acc + eta.pose[b] * Ssym[a][b][None, :]
        rot.append(acc)
    sph = eta.sph * s_inner if meta.l else eta.sph
    return Planar(pose=tuple(rot + [jnp.zeros_like(eta.pose[d])]),
                  sph=sph, tail=jnp.zeros_like(eta.tail))


def precondition_planar(TP: TiledProblem, Vp: Planar) -> Planar:
    meta = TP.meta
    if TP.btd_ltil is not None or TP.diag_inv is not None:
        # tile/band solves need the interleaved layout: 2 relayouts per
        # apply (once per tCG iteration) buy the much stronger
        # preconditioner
        return to_planar(meta, precondition_flat(TP, from_planar(meta,
                                                                 Vp)))
    dh = meta.dh
    inv = TP.pose_inv.astype(Vp.pose[0].dtype)
    out = []
    for e in range(dh):
        acc = Vp.pose[0] * inv[0, e][None, :]
        for c in range(1, dh):
            acc = acc + Vp.pose[c] * inv[c, e][None, :]
        out.append(acc)
    sph = Vp.sph * TP.sph_inv.astype(Vp.sph.dtype)[None, :] \
        if meta.l else Vp.sph
    if meta.b:
        lmk = Vp.tail[:, :meta.b] * \
            TP.lmk_inv.astype(Vp.tail.dtype)[None, :]
        tail = jnp.concatenate([lmk, Vp.tail[:, meta.b:]], axis=1)
    else:
        tail = Vp.tail
    return Planar(pose=tuple(out), sph=sph, tail=tail)


_NS_ITERS = 36  # Newton-Schulz sweeps; see retract_planar


def retract_planar(meta: TiledMeta, Xp: Planar, Vp: Planar) -> Planar:
    """Polar retraction, fully lane-parallel (no batched eigh).

    The Gram matrices M_i = A_i^T A_i (A = X + V) are d x d symmetric
    per-pose; their inverse square roots are computed with the coupled
    Newton-Schulz iteration  Y <- Y (3I - ZY)/2, Z <- (3I - ZY) Z / 2
    (Y -> B^{1/2}, Z -> B^{-1/2} for B = M/s, s >= lambda_max via the
    trace bound), entirely as elementwise ops on [n] vectors instead of
    the batched [n, d, d] eigh of retract_flat.
    Convergence: lambda_min(M) >= 1 when X is feasible and V tangent
    (M = I + V^T V), so scaled eigenvalues lie in [1/s, 1] and _NS_ITERS
    sweeps contract the slowest mode by 1.5^k -- 36 sweeps cover
    s <= ~1e6, i.e. tangent steps up to norm ~1e3 per pose.
    """
    d = meta.d
    A = [Xp.pose[c] + Vp.pose[c] for c in range(meta.dh)]
    idx = [(a, b) for a in range(d) for b in range(a, d)]
    M = {}
    for a, b in idx:
        M[(a, b)] = jnp.sum(A[a] * A[b], axis=0)  # [n]

    def get(H, a, b):
        return H[(a, b)] if (a, b) in H else H[(b, a)]

    tr = sum(M[(a, a)] for a in range(d))
    s = jnp.maximum(tr, 1e-12)  # >= lambda_max; M PSD
    B = {ab: M[ab] / s for ab in M}
    Y = dict(B)
    Z = {(a, b): (jnp.ones_like(tr) if a == b else jnp.zeros_like(tr))
         for (a, b) in idx}

    def sym_mul(H1, H2):
        # T = 3I - H1 @ H2 (general d x d product of symmetric operands,
        # returned as a full dict over (a, b) pairs, not symmetric itself)
        T = {}
        for a in range(d):
            for b in range(d):
                acc = sum(get(H1, a, c) * get(H2, c, b) for c in range(d))
                T[(a, b)] = (3.0 if a == b else 0.0) - acc
        return T

    for _ in range(_NS_ITERS):
        T = sym_mul(Z, Y)  # T = 3I - Z Y
        # Y <- 0.5 Y T ; Z <- 0.5 T Z  (keep only upper triangles: both
        # iterates stay symmetric in exact arithmetic)
        Yn, Zn = {}, {}
        for a, b in idx:
            Yn[(a, b)] = 0.5 * sum(
                get(Y, a, c) * T[(c, b)] for c in range(d))
            Zn[(a, b)] = 0.5 * sum(
                T[(a, c)] * get(Z, c, b) for c in range(d))
        Y, Z = Yn, Zn

    rs = jax.lax.rsqrt(s)  # M^{-1/2} = Z / sqrt(s)
    rot = []
    for b in range(d):
        acc = A[0] * (get(Z, 0, b) * rs)[None, :]
        for a in range(1, d):
            acc = acc + A[a] * (get(Z, a, b) * rs)[None, :]
        rot.append(acc)
    if meta.l:
        S = Xp.sph + Vp.sph
        nrm = jnp.linalg.norm(S, axis=0, keepdims=True)
        sph = S / jnp.where(nrm == 0, 1.0, nrm)
    else:
        sph = Xp.sph + Vp.sph
    return Planar(pose=tuple(rot + [A[d]]),
                  sph=sph, tail=Xp.tail + Vp.tail)


def cost_flat(TP: TiledProblem, Xf: jax.Array,
              Gf: Optional[jax.Array] = None):
    """f = 0.5 <Xf Q, Xf> + <Xf, Gf>."""
    f = 0.5 * jnp.vdot(apply_tiled(TP, Xf), Xf)
    if Gf is not None:
        f = f + jnp.vdot(Xf, Gf)
    return f


def egrad_flat(TP: TiledProblem, Xf: jax.Array,
               Gf: Optional[jax.Array] = None) -> jax.Array:
    W = apply_tiled(TP, Xf)
    return W if Gf is None else W + Gf
