"""Batch solvers: local PGO, averaging, and entry points.

Mirrors the reference's DCORA_solver.cpp surface (solvePGO, solveRobustPGO,
single/robust rotation & pose averaging, chordal/odometry initialization
re-exports) on top of the JAX engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from dcora_tpu.core import lifted, problem as prob
from dcora_tpu.core.graph import LocalGraph
from dcora_tpu.core.init import chordal_initialization, odometry_initialization
from dcora_tpu.core.lifted import RAState
from dcora_tpu.core.rtr import RTRConfig, rtr
from dcora_tpu.measurements import RelativePosePoseMeasurement
from dcora_tpu.types import GraphType, ROptParameters, RobustCostParameters


def _zero_G(dims, r):
    return lifted.zeros(dims, r)


# below this size the f32 coarse phase's extra compilations cost more than
# the f64 iterations they save
FAST_PATH_MIN_POSES = 500


def rtr_config_from_params(params: ROptParameters,
                           single_step: bool = False) -> RTRConfig:
    return RTRConfig(
        gradnorm_tol=params.gradnorm_tol,
        max_outer=params.RTR_iterations,
        max_inner=params.RTR_tCG_iterations,
        initial_radius=params.RTR_initial_radius,
        single_accepted_step=single_step,
    )


def build_pgo_graph(measurements: List[RelativePosePoseMeasurement],
                    r: Optional[int] = None) -> LocalGraph:
    d = measurements[0].t.shape[0]
    robot = measurements[0].r1
    g = LocalGraph(robot, r if r is not None else d, d, GraphType.PoseGraph)
    g.set_measurements(measurements)
    return g


def precond_reg(g: LocalGraph, P: prob.ProblemData) -> float:
    """Reference regularization rule: 1e-1 for PGO, lambda_max/(1e6-1) for
    RA-SLAM (Graph.cpp:1901-1960)."""
    if g.is_pgo_compatible():
        return 1e-1
    probe = lifted.zeros(g.dims, 1)
    lam = prob.power_iteration_lambda_max(P, probe)
    return float(lam) / (1e6 - 1.0)


def make_preconditioner(g: LocalGraph, P: prob.ProblemData):
    """Factored block-Jacobi preconditioner of the local Q.

    Uses the native (C++) block assembly when available -- this is a
    host-side graph-builder step, called on every data-matrix refresh in
    the RBCD loop; falls back to the jnp implementation otherwise."""
    reg = precond_reg(g, P)

    from dcora_tpu import native

    if native.available():
        a = np.asarray
        out = native.jacobi_precond(
            g.n, g.l, g.b, g.d, reg,
            a(P.pp_ri), a(P.pp_rj), a(P.pp_t), a(P.pp_kappa), a(P.pp_tau),
            a(P.pp_w) * a(P.pp_active),
            a(P.pl_ri), a(P.pl_tj), a(P.pl_t), a(P.pl_tau),
            a(P.pl_w) * a(P.pl_active),
            a(P.rg_ti), a(P.rg_tj), a(P.rg_q), a(P.rg_rho), a(P.rg_prec),
            a(P.rg_w) * a(P.rg_active),
        )
        if out is not None:
            pose_inv, sph_diag, lmk_diag = out
            return prob.Preconditioner(
                pose_inv=jnp.asarray(pose_inv),
                sph_diag=jnp.asarray(sph_diag),
                lmk_diag=jnp.asarray(lmk_diag),
            )
    return prob.build_preconditioner(P, g.n, g.l, g.b, g.d, reg)


class TileCache:
    """Lazily-built per-precision tile forms, reused across staircase ranks
    (tiles are rank-independent)."""

    def __init__(self, f32=None, f64=None):
        self.f32 = f32
        self.f64 = f64


def rtr_fast(g: LocalGraph, P: prob.ProblemData, M, X0: RAState,
             cfg: RTRConfig, G: Optional[RAState] = None, TP=None,
             coarse_rel: float = 1e-4, skip_coarse: bool = False):
    """Mixed-precision RTR staircase: f32 tiles -> f64 tiles -> f64 edge.

    Three phases, each driven to the requested tolerance or its own
    precision/efficiency floor:
      1. flat RCM-tiled backend at f32;
      2. the same tiled backend at f64 until tolerance or stall -- the
         assembled Q loses ~6 digits to cancellation near optima, so its
         gradnorm floor sits around 1e-10 * problem scale;
      3. the exact residual-form f64 edge path finishes to
         cfg.gradnorm_tol and produces the returned result.
    Returns (RTRResult, TileCache); pass the cache back in to reuse both
    tile precisions across calls.
    """
    import jax

    from dcora_tpu.core import tiled
    from dcora_tpu.core.manifold import project
    from dcora_tpu.core.rtr import FLAT_BACKEND, rtr, rtr_chunked

    r = X0.r
    r_pad = max(8, -(-r // 8) * 8)
    if TP is None:
        TP = TileCache()
    elif not isinstance(TP, TileCache):  # bare f32 TiledProblem
        TP = TileCache(f32=TP)
    # RA problems (unit spheres present) get the strong preconditioner:
    # on range-coupled Q the per-pose Jacobi leaves tCG badly
    # conditioned (single_drone rank-3: 49 outers to 1e-4 with tile
    # blocks vs stalled at 5.8e-2 after 60 without); the default is the
    # block-tridiagonal RCM-band factorization (tiled._factor_btd) which
    # additionally captures adjacent-tile coupling (tiers rank-2 stalled
    # at 2.4e-3 under the diagonal-tile solve).  DCORA_RA_PRECOND
    # overrides: "btd" | "tile" | "pose".  On PGO all behave near
    # identically, so the cheaper per-pose path stays.
    import os

    mode = os.environ.get("DCORA_RA_PRECOND", "btd")
    if g.l > 0 and mode != "pose":
        tile_pc = "btd" if mode == "btd" else True
    else:
        # PGO preconditioner policy by graph shape.  Chain-like graphs
        # (few loop closures relative to n: the kitti series has ~40 LCs
        # over ~4.6k poses) leave the per-pose Jacobi nearly useless —
        # measured on kitti_02 at rank 5: 60 RTR outers reach gradnorm
        # 7.6 under pose-Jacobi vs 1.9e-7 under the BTD band factor
        # (which is essentially exact on a chain).  Loop-dense graphs
        # (city10000: ~1.07 LCs/pose) converge fine under the cheaper
        # per-pose blocks, and the BTD's sequential nt-step scan would
        # only slow their tCG.  DCORA_PGO_PRECOND=btd|tile|pose
        # overrides the heuristic.
        mode_pgo = os.environ.get("DCORA_PGO_PRECOND", "")
        if mode_pgo:
            tile_pc = ("btd" if mode_pgo == "btd"
                       else True if mode_pgo == "tile" else False)
        else:
            m_pp = int(P.pp_ri.shape[0])
            lc_ratio = max(m_pp - (g.n - 1), 0) / max(g.n, 1)
            tile_pc = "btd" if lc_ratio < 0.2 else False
    reg = precond_reg(g, P) if tile_pc else 0.1
    if TP.f32 is None:
        TP.f32 = tiled.build_tiled(P, g.dims, precond=M, reg=reg,
                                   tile_precond=tile_pc)
    del coarse_rel  # kept for API compat; the stall loops below adapt

    def drive_tiled(TPx, X_state, chunk):
        """Chunked tiled RTR at TPx's dtype until tol or stall.  Each
        device call runs `chunk` outer iterations; between calls the host
        checks the stall rule below.  The chunk is capped so one device
        call stays ~10 s by a bandwidth estimate: (chunk outers) x
        (max_inner+3 SpMMs) x (tile bytes) / effective-BW, which bounds
        how long a stalled solve runs past its precision floor."""
        dt = TPx.Q.tiles.dtype
        tile_bytes = (TPx.Q.tiles.size * TPx.Q.tiles.dtype.itemsize)
        bw = 300e9 if dt == jnp.float32 else 40e9
        per_outer_s = (cfg.max_inner + 3) * tile_bytes / bw
        chunk = max(1, min(chunk, int(10.0 / max(per_outer_s, 1e-9))))
        Xf = tiled.to_flat(TPx, X_state, r_pad=r_pad).astype(dt)
        Gf = None
        if G is not None:
            Gf = tiled.to_flat(TPx, G, r_pad=r_pad).astype(dt)
        cfg_t = dataclasses.replace(cfg, gradnorm_tol=max(cfg.gradnorm_tol,
                                                          1e-30))
        cfg_c = dataclasses.replace(cfg_t, max_outer=chunk)
        total = 0
        prev_gn = gn_last = float("inf")
        # radius persists across device calls; seeded as a jnp scalar at
        # the tile dtype so all chunks share one jit signature (see
        # rtr_chunked / _rtr_impl)
        rad = jnp.asarray(cfg.initial_radius, dtype=dt)
        while total < cfg.max_outer:
            res_t = rtr(TPx, Gf, None, Xf, cfg_c, be=FLAT_BACKEND,
                        radius0=rad)
            Xf = res_t.X
            rad = res_t.radius_final
            gn = gn_last = float(res_t.gradnorm_final)
            total += int(res_t.outer_iters)
            if gn < cfg_t.gradnorm_tol or int(res_t.outer_iters) < chunk:
                break
            if gn > 0.7 * prev_gn:
                break  # precision floor: <30% improvement over a chunk
            prev_gn = gn
        X_out = project(
            jax.tree.map(lambda a: a.astype(jnp.float64),
                         tiled.from_flat(TPx, Xf, r=r))
        )
        # gn_last stays inf when the loop never produced a result
        # (max_outer <= 0) AND when an immediately-converged first chunk
        # reported outer_iters == 0 — in that case the recorded gradnorm
        # is still meaningful, so prefer it
        return X_out, gn_last

    # Warm starts that are already near-critical (staircase continue
    # retries, refinement of a certified rank) skip the coarse phases:
    # re-entering phase 1 casts the iterate to f32, which *degrades* a
    # converged point and wastes the whole chunk recovering.  One exact
    # edge-path gradnorm probe (one SpMM) decides.
    from dcora_tpu.core.rtr import RA_BACKEND, tadd, tnorm

    W0 = RA_BACKEND.applyQ(P, X0)
    eg0 = W0 if G is None else tadd(W0, G)
    gn0 = float(tnorm(RA_BACKEND.tangent(P, X0, eg0)))
    # skip_coarse: the caller knows the iterate is already near-critical
    # (e.g. a staircase continue-retry) — casting it to f32 for phase 1
    # would DEGRADE it and the retry would stall just above the 100*tol
    # gate (kitti_00/05/09 sat at gradnorm 1.3-4e-2 this way)
    if skip_coarse or gn0 < 100.0 * cfg.gradnorm_tol:
        X_warm, gn32 = X0, gn0
    else:
        # phase 1: f32 coarse
        X_warm, gn32 = drive_tiled(TP.f32, X0, chunk=25)
    # phase 2: f64 tiles, only when the f32 phase stalled above tolerance
    # (small problems/tolerances often finish in phase 1)
    if not skip_coarse and gn32 > cfg.gradnorm_tol \
            and gn0 >= 100.0 * cfg.gradnorm_tol:
        if TP.f64 is None:
            TP.f64 = tiled.build_tiled(P, g.dims, precond=M, reg=reg,
                                       dtype=np.float64,
                                       tile_precond=tile_pc)
        X_warm, _ = drive_tiled(TP.f64, X_warm, chunk=8)
    # phase 3: exact residual-form finish.  As in drive_tiled, cap the
    # outer iterations per device call so one call stays ~20 s, by a
    # cost estimate of ~3.5 us per edge per SpMV (a host-side constant
    # from the edge path's gather/scatter; the cap only bounds the
    # length of one call, so a rough figure is enough).
    m_edges = int(P.pp_ri.shape[0]) + int(P.pl_ri.shape[0]) + \
        int(P.rg_ti.shape[0])
    per_inner_s = 3.5e-6 * max(m_edges, 1)
    cfg_e = cfg
    per_outer_s = (cfg.max_inner + 3) * per_inner_s
    if per_outer_s > 15.0:
        # chunk=1 is the floor for rtr_chunked, but ONE outer is itself a
        # single device call of (max_inner tCG steps); shrink the
        # per-outer tCG budget so a single outer stays ~15 s.  tCG
        # restarts every outer, so a smaller inner budget costs extra
        # outers, not correctness.
        inner_eff = max(8, int(15.0 / per_inner_s) - 3)
        cfg_e = dataclasses.replace(cfg, max_inner=inner_eff)
        per_outer_s = (inner_eff + 3) * per_inner_s
    chunk3 = max(1, min(4, int(20.0 / max(per_outer_s, 1e-9))))
    return rtr_chunked(P, G, M, X_warm, cfg_e, chunk=chunk3), TP


def solve_pgo(measurements: List[RelativePosePoseMeasurement],
              params: Optional[ROptParameters] = None,
              T0: Optional[np.ndarray] = None,
              fast: bool = True) -> np.ndarray:
    """Single-robot rank-d PGO (reference: DCORA_solver.cpp:304-330).

    Returns the optimized trajectory [n, d, d+1].
    """
    params = params or ROptParameters()
    d = measurements[0].t.shape[0]
    T = T0 if T0 is not None else chordal_initialization(measurements)
    g = build_pgo_graph(measurements, r=d)
    P = g.problem_data()
    M = make_preconditioner(g, P)
    X0 = lifted.from_pose_array(T)
    cfg = rtr_config_from_params(params)
    # priors (if any) contribute their linear term; None otherwise
    G = prob.linear_term(P, None, g.n, g.l, g.dims.num_trans)
    # the f32 coarse phase pays two extra XLA compilations; only worth it
    # when the f64 iteration cost dominates (big problems)
    if fast and g.n >= FAST_PATH_MIN_POSES:
        res, _ = rtr_fast(g, P, M, X0, cfg, G=G)
    else:
        res = rtr(P, G if G is not None else _zero_G(g.dims, d),
                  M, X0, cfg)
    X = res.X
    out = np.zeros((g.n, d, d + 1))
    out[:, :, :d] = np.asarray(X.rot)
    out[:, :, d] = np.asarray(X.trn)
    return out


# --- averaging (reference: DCORA_solver.cpp:30-216) -------------------------


def single_translation_averaging(tVec: List[np.ndarray],
                                 tau: Optional[np.ndarray] = None
                                 ) -> np.ndarray:
    t = np.stack(tVec)
    w = np.ones(len(tVec)) if tau is None else np.asarray(tau)
    return (w[:, None] * t).sum(0) / w.sum()


def single_rotation_averaging(RVec: List[np.ndarray],
                              kappa: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    from dcora_tpu.core.manifold import rotation_project

    R = np.stack(RVec)
    w = np.ones(len(RVec)) if kappa is None else np.asarray(kappa)
    M = (w[:, None, None] * R).sum(0)
    return np.asarray(rotation_project(jnp.asarray(M)))


def single_pose_averaging(RVec, tVec, kappa=None, tau=None):
    return (single_rotation_averaging(RVec, kappa),
            single_translation_averaging(tVec, tau))


def _gnc_averaging_loop(update_fn, residual_fn, n, barc, kappa_like):
    """Shared GNC-TLS loop for robust averaging
    (reference: DCORA_solver.cpp:76-216)."""
    from dcora_tpu.core.robust import RobustCost

    w_tol = 1e-8
    weights = np.ones(n)
    est = update_fn(weights)
    rsq = residual_fn(est)
    barc_sq = barc * barc
    mu_init = barc_sq / (2 * rsq.max() - barc_sq)
    mu_init = min(mu_init, 1e-5)
    if mu_init > 0:
        params = RobustCostParameters(
            costType=__import__(
                "dcora_tpu.types", fromlist=["RobustCostType"]
            ).RobustCostType.GNC_TLS,
            GNCBarc=barc,
            GNCMaxNumIters=1000,
            GNCInitMu=mu_init,
        )
        cost = RobustCost(params)
        for _ in range(params.GNCMaxNumIters):
            est = update_fn(weights)
            rsq = residual_fn(est)
            w = cost.weight(np.sqrt(rsq))
            weights = w
            nc = np.sum((w < w_tol) | (w > 1 - w_tol))
            if nc == n:
                break
            cost.update()
    inliers = [i for i in range(n) if weights[i] > 1 - w_tol]
    return est, inliers, weights


def robust_single_rotation_averaging(RVec: List[np.ndarray],
                                     kappa: Optional[np.ndarray] = None,
                                     error_threshold: float = 1.0):
    """GNC-TLS robust rotation averaging
    (reference: DCORA_solver.cpp:76-134). Returns (ROpt, inlier_indices)."""
    n = len(RVec)
    kap = np.ones(n) if kappa is None else np.asarray(kappa)
    R = np.stack(RVec)

    def update(weights):
        return single_rotation_averaging(RVec, kap * weights)

    def residual(ROpt):
        return kap * ((ROpt[None] - R) ** 2).sum(axis=(1, 2))

    est, inliers, _ = _gnc_averaging_loop(
        update, residual, n, error_threshold, kap
    )
    return est, inliers


def robust_single_pose_averaging(RVec, tVec, kappa=None, tau=None,
                                 error_threshold: float = 1.0):
    """GNC-TLS robust pose averaging (reference: DCORA_solver.cpp:136-216)."""
    n = len(RVec)
    kap = 10000 * np.ones(n) if kappa is None else np.asarray(kappa)
    ta = 100 * np.ones(n) if tau is None else np.asarray(tau)
    R = np.stack(RVec)
    t = np.stack(tVec)

    def update(weights):
        return single_pose_averaging(RVec, tVec, kap * weights, ta * weights)

    def residual(est):
        ROpt, tOpt = est
        return (kap * ((ROpt[None] - R) ** 2).sum(axis=(1, 2))
                + ta * ((tOpt[None] - t) ** 2).sum(axis=1))

    est, inliers, _ = _gnc_averaging_loop(
        update, residual, n, error_threshold, kap
    )
    return est[0], est[1], inliers


def compute_measurement_error(m: RelativePosePoseMeasurement,
                              R1, t1, R2, t2) -> float:
    """kappa*||R1 R_m - R2||^2 + tau*||t2 - t1 - R1 t_m||^2
    (reference: DCORA_utils.cpp:2095-2101)."""
    rot_err = float(((R1 @ m.R - R2) ** 2).sum())
    tr_err = float(((t2 - t1 - R1 @ m.t) ** 2).sum())
    return m.kappa * rot_err + m.tau * tr_err


@dataclasses.dataclass
class SolveRobustPGOParams:
    """reference: DCORA_solver.h solveRobustPGOParams."""

    opt_params: ROptParameters = dataclasses.field(
        default_factory=lambda: ROptParameters(
            gradnorm_tol=1.0, RTR_iterations=20
        )
    )
    robust_params: RobustCostParameters = dataclasses.field(
        default_factory=RobustCostParameters
    )
    verbose: bool = False


def solve_robust_pgo(measurements: List[RelativePosePoseMeasurement],
                     params: Optional[SolveRobustPGOParams] = None,
                     T0: Optional[np.ndarray] = None) -> np.ndarray:
    """GNC outer loop around solve_pgo, mutating measurement weights in
    place (reference: DCORA_solver.cpp:332-409)."""
    from dcora_tpu.core.robust import RobustCost
    from dcora_tpu.types import RobustCostType

    params = params or SolveRobustPGOParams()
    w_tol = 1e-8
    T = solve_pgo(measurements, params.opt_params, T0)

    def residuals(T):
        rs = np.zeros(len(measurements))
        for i, m in enumerate(measurements):
            rs[i] = compute_measurement_error(
                m, T[m.p1, :, :-1], T[m.p1, :, -1],
                T[m.p2, :, :-1], T[m.p2, :, -1],
            )
        return rs

    for m in measurements:
        m.weight = 1.0
    rsq = residuals(T)
    barc = params.robust_params.GNCBarc
    barc_sq = barc * barc
    mu_init = barc_sq / (2 * rsq.max() - barc_sq)
    gnc_params = dataclasses.replace(
        params.robust_params, GNCInitMu=mu_init,
        costType=RobustCostType.GNC_TLS,
    )
    if mu_init > 0:
        cost = RobustCost(gnc_params)
        for it in range(gnc_params.GNCMaxNumIters):
            T = solve_pgo(measurements, params.opt_params, T0)
            rsq = residuals(T)
            num_undecided = 0
            for i, m in enumerate(measurements):
                if m.fixedWeight:
                    continue
                m.weight = float(cost.weight(np.sqrt(rsq[i])))
                if w_tol <= m.weight <= 1 - w_tol:
                    num_undecided += 1
            if params.verbose:
                print(f"[solve_robust_pgo] iter {it}: "
                      f"{num_undecided} undecided")
            if num_undecided == 0:
                break
            cost.update()
    return solve_pgo(measurements, params.opt_params, T0)


__all__ = [
    "solve_pgo",
    "solve_robust_pgo",
    "SolveRobustPGOParams",
    "chordal_initialization",
    "odometry_initialization",
    "single_rotation_averaging",
    "single_translation_averaging",
    "single_pose_averaging",
    "robust_single_rotation_averaging",
    "robust_single_pose_averaging",
    "compute_measurement_error",
]
