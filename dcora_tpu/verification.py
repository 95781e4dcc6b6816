"""Independent solution verification via scipy (no JAX, no engine reuse).

Parity evidence for this build: the reference binaries cannot be built
in this environment (their cmake fetches ROPTLIB/Spectra/gtest from GitHub
at configure time — cmake/roptlib.cmake:6, cmake/spectra.cmake:5,
cmake/gtest.cmake:7 — and the system lacks Eigen/SuiteSparse/Boost/glog;
zero network egress).  Certifiable optimization gives an alternative,
*falsifiable* parity protocol: the rank-restricted SDP relaxation has a
unique certified optimum, so if this build's solution passes an
independently-constructed dual-certificate check, it is the same global
optimum the reference computes (both certify against the same matrix
S = Q - Lambda(X), DCORA_utils.cpp:1898-1982).

This module implements that check end-to-end in scipy, fully independent
of the JAX engine:

  * ``sparse_Q_ra``     — data matrix Q assembled from incidence matrices
    (the documented construction of Graph.cpp:579-683 and :824-1188),
    RA column ordering [Y1..Yn | r1..rl | p1..pn | L1..Lb];
  * ``riemannian_gradnorm`` — first-order criticality of X under that Q;
  * ``certificate_min_eig`` — lambda_min(S) via scipy.sparse.linalg on
    S = Q - Lambda(X) with Lambda assembled from X and Q directly.

``verify_solution`` bundles the three into one report dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from dcora_tpu.measurements import (
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)
from dcora_tpu.types import StateType


def split_measurements(measurements):
    pp, pl, rg = [], [], []
    for m in measurements:
        if isinstance(m, RelativePosePoseMeasurement):
            pp.append(m)
        elif isinstance(m, RelativePoseLandmarkMeasurement):
            pl.append(m)
        elif isinstance(m, RangeMeasurement):
            rg.append(m)
        else:
            raise TypeError(type(m))
    return pp, pl, rg


def sparse_Q_ra(pose_pose: List, pose_landmark: List, ranges: List,
                n: int, l: int, b: int, d: int) -> sp.csr_matrix:  # noqa: E741
    """Q in RA ordering from incidence matrices (scipy-only)."""
    mpp = len(pose_pose)
    mpl = len(pose_landmark)
    mrg = len(ranges)
    mpose = mpp + mpl

    ARhoT = sp.lil_matrix((d * n, d * mpp))
    ATauT = sp.lil_matrix((n + b, mpose))
    TT = sp.lil_matrix((d * n, mpose))
    omega_rho = np.zeros(d * mpp)
    omega_tau = np.zeros(mpose)

    for k, meas in enumerate(pose_pose):
        i, j = meas.p1, meas.p2
        w = meas.weight
        omega_rho[k * d:(k + 1) * d] = w * meas.kappa
        omega_tau[k] = w * meas.tau
        ARhoT[i * d:(i + 1) * d, k * d:(k + 1) * d] = -meas.R
        for r in range(d):
            ARhoT[j * d + r, k * d + r] = 1.0
        TT[i * d:(i + 1) * d, k] = -meas.t.reshape(-1, 1)
        ATauT[i, k] = -1.0
        ATauT[j, k] = 1.0

    for kk, meas in enumerate(pose_landmark):
        k = mpp + kk
        i, j = meas.p1, meas.p2
        omega_tau[k] = meas.weight * meas.tau
        TT[i * d:(i + 1) * d, k] = -meas.t.reshape(-1, 1)
        ATauT[i, k] = -1.0
        ATauT[n + j, k] = 1.0

    CT = sp.lil_matrix((n + b, mrg))
    PT = sp.lil_matrix((l, mrg))
    DT = sp.lil_matrix((mrg, mrg))
    omega_rng = np.zeros(mrg)

    def trans_idx(p, st):
        return p if st == StateType.Pose else n + p

    for k, meas in enumerate(ranges):
        omega_rng[k] = meas.weight * meas.precision
        DT[k, k] = meas.range
        PT[meas.l, k] = 1.0
        CT[trans_idx(meas.p1, meas.stateType1), k] = -1.0
        CT[trans_idx(meas.p2, meas.stateType2), k] = 1.0

    ARhoT, ATauT, TT, CT, PT, DT = (
        x.tocsr() for x in (ARhoT, ATauT, TT, CT, PT, DT)
    )
    ORho = sp.diags(omega_rho)
    OTau = sp.diags(omega_tau)
    ORng = sp.diags(omega_rng)

    Q11 = ARhoT @ ORho @ ARhoT.T + TT @ OTau @ TT.T
    Q13 = TT @ OTau @ ATauT.T
    Q22 = PT @ ORng @ DT @ DT @ PT.T
    Q23 = PT @ DT @ ORng @ CT.T
    Q33 = ATauT @ OTau @ ATauT.T + CT @ ORng @ CT.T

    zero_l = sp.csr_matrix((d * n, l))
    Q = sp.bmat(
        [[Q11, zero_l, Q13],
         [zero_l.T, Q22, Q23],
         [Q13.T, Q23.T, Q33]],
        format="csr",
    )
    return Q


def _sym(A):
    return 0.5 * (A + A.T)


def riemannian_gradnorm(Q: sp.csr_matrix, Xf: np.ndarray, n: int,
                        l: int, d: int) -> float:  # noqa: E741
    """||P_T(X Q)||_F with the tangent projection done in numpy:
    Stiefel blocks V - Y sym(Y^T V); oblique columns v - s <s,v>;
    Euclidean identity."""
    E = Xf @ Q  # [r, k]
    G = E.copy()
    for i in range(n):
        Y = Xf[:, i * d:(i + 1) * d]
        V = E[:, i * d:(i + 1) * d]
        G[:, i * d:(i + 1) * d] = V - Y @ _sym(Y.T @ V)
    for q in range(l):
        s = Xf[:, n * d + q]
        v = E[:, n * d + q]
        G[:, n * d + q] = v - s * float(s @ v)
    return float(np.linalg.norm(G))


def certificate_matrix(Q: sp.csr_matrix, Xf: np.ndarray, n: int,
                       l: int, d: int) -> sp.csc_matrix:  # noqa: E741
    """S = Q - Lambda(X): Lambda has sym(Y_i^T (XQ)_i) blocks on the
    Stiefel diagonal and <s_q, (XQ)_q> on the oblique diagonal
    (DCORA_utils.cpp:1898-1982), assembled from X and Q directly."""
    E = Xf @ Q
    blocks = []
    rows, cols, vals = [], [], []
    for i in range(n):
        Lam = _sym(Xf[:, i * d:(i + 1) * d].T @ E[:, i * d:(i + 1) * d])
        for a in range(d):
            for c in range(d):
                rows.append(i * d + a)
                cols.append(i * d + c)
                vals.append(Lam[a, c])
    for q in range(l):
        lam = float(Xf[:, n * d + q] @ E[:, n * d + q])
        rows.append(n * d + q)
        cols.append(n * d + q)
        vals.append(lam)
    k_dim = Q.shape[0]
    Lambda = sp.csr_matrix((vals, (rows, cols)), shape=(k_dim, k_dim))
    return (Q - Lambda).tocsc()


def certificate_min_eig(Q: sp.csr_matrix, Xf: np.ndarray, n: int,
                        l: int, d: int,
                        tol: float = 0.0, S=None):  # noqa: E741
    """(theta, resid) estimate for the bottom of spec(S), S = Q - Lambda(X).

    theta is the exact Rayleigh quotient v^T S v of the estimated minimum
    eigenvector (an UPPER bound on lambda_min); resid = ||S v - theta v||
    quantifies how converged the estimate is.  **This is a diagnostic,
    never a certification basis**: a tiny resid only proves (theta, v) is
    close to SOME eigenpair, not that it is the bottom one.  At a critical
    point S has an r-dimensional near-zero cluster (S Xf^T ~ 0), so
    iterative solvers happily converge inside the cluster while a
    decisively negative lambda_min sits below it (observed on tiers.pyfg:
    lambda_min = -7.7e-3, cluster pair returned with resid ~ 4e-12).
    ``verify_solution`` therefore certifies exclusively through the LDL^T
    inertia proof and treats this value as reporting detail."""
    if S is None:
        S = certificate_matrix(Q, Xf, n, l, d)
    k_dim = S.shape[0]

    from scipy.sparse.linalg import ArpackNoConvergence, eigsh, lobpcg

    # Shift-invert just below zero finds the eigenvalue nearest sigma.
    # That pair is the TRUE bottom of the spectrum only when nothing lies
    # below sigma — which an LDL^T inertia proof of S - sigma*I can
    # witness (all eigenvalues >= sigma, and "nearest to sigma from
    # above" = minimum).  Without that witness the pair may be a cluster
    # member above a more-negative lambda_min, so fall through to the
    # spectrum-shifted Lanczos instead of returning it.
    sigma = -(2.0 * tol) if tol > 0 else -1e-6
    try:
        w_si, v_si = eigsh(S, k=1, sigma=sigma, which="LM", maxiter=500)
        v = v_si[:, 0] / np.linalg.norm(v_si[:, 0])
        Sv = S @ v
        theta = float(v @ Sv)
        resid = float(np.linalg.norm(Sv - theta * v))
        if resid <= max(1e-8 * max(abs(theta), 1.0), 1e-10):
            from dcora_tpu.core.certify import ldl_psd_proof

            floor_proof = ldl_psd_proof(
                (S - sigma * sp.identity(k_dim, format="csc")).tocsc()
            )
            if floor_proof is True:
                return theta, resid
            # floor not proven: the nearest-to-sigma pair cannot be
            # trusted as the bottom; continue to the shifted Lanczos
    except Exception:  # noqa: BLE001  (singular shift, ARPACK failure)
        pass

    # Spectrum-shifted Lanczos (the SE-Sync strategy the reference uses,
    # DCORA_utils.cpp:1807-1896): ask for the largest-magnitude eigenvalue
    # first, then the smallest of (S - lam_max I) recovers lambda_min
    # robustly even when S >= 0 with a near-zero bottom eigenvalue.

    lam_max = float(eigsh(S, k=1, which="LA", return_eigenvectors=False,
                          tol=1e-4, ncv=min(k_dim, 50))[0])
    shift = 1.01 * max(lam_max, 1e-6)
    # B = shift*I - S is PSD with dominant eigenvalue shift - lambda_min,
    # which Lanczos finds fastest (dominant extreme); recover lambda_min.
    # At a certified optimum the top of B is heavily clustered (every
    # near-zero eigenvalue of S maps near `shift`), so give Lanczos a real
    # subspace (ncv) and validate through the Rayleigh quotient; on ARPACK
    # non-convergence fall back to block LOBPCG, which handles clusters.
    B = (shift * sp.identity(k_dim, format="csc") - S).tocsr()
    rng = np.random.default_rng(0)
    try:
        # maxiter counts ARPACK restart cycles (~ncv matvecs each).  At a
        # certified optimum the top of B is a CLUSTER, where ARPACK tends
        # to non-convergence no matter the budget — the old 40*k cap spun
        # for >30 min on kitti_00 (k=13.6k) before the fallback fired.
        # The eigenpair here is diagnostic (theta/resid); the PSD decision
        # is fail-closed through certificate_psd_proof's LDL^T witness,
        # so a bounded budget costs soundness nothing.
        vals, vecs = eigsh(B, k=1, which="LA", tol=1e-7,
                           ncv=min(k_dim, 96), maxiter=300,
                           v0=rng.standard_normal(k_dim))
        v = vecs[:, 0]
    except ArpackNoConvergence as e:
        if len(e.eigenvectors) and e.eigenvectors.shape[1]:
            v = e.eigenvectors[:, -1]
        else:
            Xb = rng.standard_normal((k_dim, 4))
            w, Vb = lobpcg(B, Xb, tol=1e-6, maxiter=500, largest=True)
            v = Vb[:, int(np.argmax(w))]
    v = v / np.linalg.norm(v)
    Sv = S @ v
    theta = float(v @ Sv)  # exact Rayleigh quotient of the estimate
    resid = float(np.linalg.norm(Sv - theta * v))
    return theta, resid


def certificate_psd_proof(Q: sp.csr_matrix, Xf: np.ndarray, n: int,
                          l: int, d: int, eta: float,
                          S=None):  # noqa: E741
    """Factorization witness that S + eta*I is PSD (independent scipy
    LDL^T via SuperLU SymmetricMode — see core.certify.ldl_psd_proof for
    the congruence argument; the analogue of the reference's CHOLMOD
    quick-return, DCORA_utils.cpp:1737-1747). True/False/None."""
    from dcora_tpu.core.certify import ldl_psd_proof

    if S is None:
        S = certificate_matrix(Q, Xf, n, l, d)
    return ldl_psd_proof(S + eta * sp.identity(S.shape[0], format="csc"))


def verify_solution(measurements, X, d: int,
                    eta: float = 1e-3) -> Dict[str, float]:
    """Full independent report for a solution RAState ``X``.

    Returns dict with: f_indep (0.5<XQ,X> under the scipy Q), gradnorm
    (Riemannian, independent), min_eig (diagnostic estimate for the dual
    certificate's bottom eigenvalue), certified (True ONLY when the
    LDL^T inertia proof witnesses S + eta*I >= 0 — eigensolver estimates
    never certify), and the manifold feasibility error.
    """
    from dcora_tpu.core import lifted

    dims = X.dims
    n, l, b = dims.n, dims.l, dims.b
    # dedup by edge ID, keeping the first occurrence — the graph layer
    # (and the reference's EdgeIDMap insert, Graph.cpp:121-281) silently
    # drops repeated edges, so the verification cost must too; kitti_06
    # carries one duplicated loop closure (850,20) that otherwise skews
    # f and the gradient by the duplicate's full weight
    seen = set()
    uniq = []
    for m in measurements:
        eid = m.edge_id()
        if eid in seen:
            # A dropped duplicate RANGE edge is stricter in the
            # reference: unit-sphere indexing must be unique, so
            # Graph::addPrivateLoopClosure LOG(FATAL)s on it.  A silent
            # drop here could mask an orphaned unit-sphere column in X —
            # surface it loudly instead of mirroring the pose-edge path.
            from dcora_tpu.measurements import RangeMeasurement

            if isinstance(m, RangeMeasurement):
                raise ValueError(
                    f"duplicate range measurement for edge {eid}: the "
                    "reference treats repeated range edges as fatal "
                    "(unique unit-sphere indexing)")
            continue
        seen.add(eid)
        uniq.append(m)
    pp, pl, rg = split_measurements(uniq)
    Q = sparse_Q_ra(pp, pl, rg, n, l, b, d)
    Xf = np.asarray(lifted.to_flat(X), dtype=np.float64)
    f = 0.5 * float(np.sum((Xf @ Q) * Xf))
    gradnorm = riemannian_gradnorm(Q, Xf, n, l, d)

    # Certification is decided EXCLUSIVELY by the LDL^T inertia proof of
    # S + eta*I (fail-closed), mirroring core.certify._min_eig_host.  An
    # eigensolver pair — however small its residual — only locates SOME
    # eigenpair; at a critical point S carries an r-dimensional near-zero
    # cluster that iterative solvers converge to while a decisively
    # negative lambda_min sits below it (the tiers.pyfg false-cert class).
    # The eigenpair estimate below is recorded as a diagnostic only.
    S = certificate_matrix(Q, Xf, n, l, d)
    psd_proof = certificate_psd_proof(Q, Xf, n, l, d, eta, S=S)
    certified = psd_proof is True
    if psd_proof is False:
        # proven indefinite below -eta: bracket lambda_min by inertia
        # bisection and pull a Rayleigh witness by shift-invert inside
        # the bracket (same structure as certify._min_eig_host)
        from dcora_tpu.core.certify import _inertia_bracket_min_eig

        min_eig, min_eig_resid = -eta, float("inf")
        br = _inertia_bracket_min_eig(S.tocsc(), eta)
        if br is not None:
            lo, hi = br
            sigma = -0.5 * (lo + hi)
            min_eig = sigma  # inertia-proven bracket midpoint
            try:
                from scipy.sparse.linalg import eigsh

                _, Vv = eigsh(S, k=1, sigma=sigma, which="LM",
                              maxiter=1000)
                v = Vv[:, 0] / np.linalg.norm(Vv[:, 0])
                Sv = S @ v
                theta = float(v @ Sv)
                if theta < -eta:
                    min_eig = theta
                    min_eig_resid = float(np.linalg.norm(Sv - theta * v))
            except Exception:  # noqa: BLE001
                pass
    else:
        # PSD-proven (True) or inconclusive (None): record the upper-bound
        # diagnostic pair.  When the proof is None the verdict stays
        # NOT certified regardless of the estimate (fail closed).
        min_eig, min_eig_resid = certificate_min_eig(
            Q, Xf, n, l, d, tol=eta, S=S
        )
        if psd_proof is None:
            import logging

            logging.getLogger(__name__).warning(
                "independent LDL^T proof inconclusive "
                "(theta_est=%.3e, resid=%.3e): failing closed",
                min_eig, min_eig_resid,
            )

    # manifold feasibility, independently: ||Y^T Y - I|| and |1 - ||s|||
    feas = 0.0
    for i in range(n):
        Y = Xf[:, i * d:(i + 1) * d]
        feas = max(feas, float(np.abs(Y.T @ Y - np.eye(d)).max()))
    for q in range(l):
        feas = max(
            feas, abs(1.0 - float(np.linalg.norm(Xf[:, n * d + q])))
        )
    return {
        "f_indep": f,
        "gradnorm_indep": gradnorm,
        "min_eig_indep": min_eig,
        "min_eig_resid_indep": min_eig_resid,
        "psd_proof_indep": psd_proof,
        "certified_indep": certified,
        "manifold_err": feas,
    }


def ate_vs_ground_truth(T_est: np.ndarray,
                        T_gt: np.ndarray) -> Optional[float]:
    """Umeyama-aligned ATE RMSE of trajectory translations."""
    from dcora_tpu.utils.evaluation import ate_rmse

    return float(ate_rmse(T_est, T_gt))
