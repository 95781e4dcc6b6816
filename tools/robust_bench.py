"""Robust GNC benchmark: outlier classification at real-benchmark scale.

Plants gross outlier loop closures into a benchmark g2o file (the
testRobust.cpp:228-309 planted-outlier pattern scaled up per
BASELINE.json config 4), then runs

  1. centralized solveRobustPGO (solvers.solve_robust_pgo) and
  2. the distributed GNC driver (multi_robot_pgo.run with GNC-TLS),

and records weight-classification precision/recall, the final cost on
the inlier-only problem vs the uncorrupted certified optimum
(artifacts/parity/<name>.json), and an independent verification of the
reweighted solution.

Usage:
  python tools/robust_bench.py --dataset sphere2500.g2o --frac 0.15
Writes artifacts/robust_<name>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

ART = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")


def classification(measurements, outlier_keys, w_tol=0.5):
    """Precision/recall of GNC weight classification: an edge classified
    'outlier' iff its final weight < w_tol.  0.5 is the natural decision
    boundary: the distributed GNC's bounded mu schedule (10 updates x
    1.4 from 1e-4, the reference defaults) legitimately leaves noisy
    inliers at partial weights, while the centralized loop drives
    weights to exactly {0, 1}."""
    tp = fp = fn = tn = 0
    for m in measurements:
        if m.fixedWeight:
            continue
        key = (m.p1, m.p2)
        rejected = m.weight < w_tol
        if key in outlier_keys:
            tp += rejected
            fn += not rejected
        else:
            fp += rejected
            tn += not rejected
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    return dict(tp=int(tp), fp=int(fp), fn=int(fn), tn=int(tn),
                precision=float(precision), recall=float(recall))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sphere2500.g2o")
    ap.add_argument("--data-dir", default=os.path.join(
        os.path.dirname(__file__), os.pardir, ".data_cache"))
    ap.add_argument("--frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--robots", type=int, default=5)
    ap.add_argument("--skip-distributed", action="store_true")
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    args = ap.parse_args()

    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import dcora_tpu  # noqa: F401
    import numpy as np

    from dcora_tpu import solvers, verification as V
    from dcora_tpu.core import lifted
    from dcora_tpu.datasets import corrupt_with_outliers, write_g2o
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.types import RobustCostParameters, RobustCostType

    name = args.dataset.replace(".g2o", "")
    path = os.path.join(args.data_dir, args.dataset)
    ds = read_g2o_file(path)
    clean = ds.pose_pose_measurements
    corrupted, outlier_keys = corrupt_with_outliers(
        clean, frac=args.frac, seed=args.seed
    )
    num_lc = sum(1 for m in corrupted if not m.fixedWeight)
    print(f"{name}: {len(clean)} edges + {len(outlier_keys)} planted "
          f"outliers ({num_lc} loop closures total)", flush=True)

    rec = dict(dataset=args.dataset, frac=args.frac, seed=args.seed,
               num_edges=len(clean), num_outliers=len(outlier_keys))
    ref_art = os.path.join(ART, "parity", f"{name}.json")
    f_clean = None
    if os.path.exists(ref_art):
        with open(ref_art) as fh:
            f_clean = json.load(fh).get("f_final")
    rec["f_clean_optimum"] = f_clean

    # -- centralized solveRobustPGO -------------------------------------
    t0 = time.time()
    params = solvers.SolveRobustPGOParams()
    params.robust_params = RobustCostParameters(
        costType=RobustCostType.GNC_TLS, GNCBarc=5.0
    )
    T = solvers.solve_robust_pgo(corrupted, params)
    rec["central"] = classification(corrupted, outlier_keys)
    rec["central"]["elapsed_s"] = time.time() - t0
    # cost of the robust solution on the CLEAN problem (inlier edges
    # only, unit weights) vs the uncorrupted certified optimum
    X = lifted.from_pose_array(T)
    saved = [(m, m.weight) for m in clean]
    for m in clean:
        m.weight = 1.0
    rep = V.verify_solution(clean, X, ds.dim, eta=1e-3)
    for m, w in saved:
        m.weight = w
    rec["central"]["f_on_clean"] = rep["f_indep"]
    rec["central"]["gradnorm_on_clean"] = rep["gradnorm_indep"]
    print(json.dumps(rec["central"]), flush=True)

    # -- distributed GNC driver ------------------------------------------
    if not args.skip_distributed:
        from dcora_tpu.drivers.multi_robot_pgo import run as run_mr

        from dcora_tpu.datasets import DATA_CACHE

        os.makedirs(DATA_CACHE, exist_ok=True)
        cpath = os.path.join(DATA_CACHE, f"{name}_corrupted.g2o")
        write_g2o(cpath, corrupted, ds.dim)
        t0 = time.time()
        # mu schedule: adaptive init from the team max residual (driver
        # computes mu0 = barc^2/(2 max r^2 - barc^2) like the central
        # loop); GNCMaxNumIters=60 lets the x1.4 ramp run as far as the
        # undecided-edge extension needs (the reference's 20-step cap
        # froze mu below the point where the TLS undecided band closes).
        # Weight updates are gradnorm-gated by the driver so residuals
        # are measured at a converged estimate of the current weighted
        # problem — the round-3 run updated on a fixed 60-round cadence
        # and falsely rejected 107 clean edges.
        # inner budget 150 (hard cap 750 rounds): with 60 the 5x cap
        # (300 rounds) preempted the gradnorm<1.0 update gate on nearly
        # every update — sequential RBCD needs ~500+ rounds to converge
        # sphere2500 at fixed weights, so residuals were still measured
        # above-convergence (precision 0.876).
        # Chordal initialization, NOT random: the central loop starts
        # every GNC stage from chordal init (solvePGO,
        # DCORA_solver.cpp:304-330), and the reference's agents get a
        # good start from odometry + the two-stage robust frame
        # alignment.  From a random start the mu ramp crosses each
        # edge's noise level while the estimate is still grossly
        # unconverged, so weakly-constrained clean loop closures read
        # as outliers and get deleted — measured: 53 false positives,
        # all private, final residuals 4-26 vs <5 at the clean optimum.
        from dcora_tpu.types import InitializationMethod

        res = run_mr(
            args.robots, cpath, r_min=5, r_max=10, num_iters=12000,
            init_method=InitializationMethod.Chordal,
            robust_inner_iters=150, robust_weight_updates=25,
            robust_cost_params=RobustCostParameters(
                costType=RobustCostType.GNC_TLS, GNCBarc=5.0,
                GNCMaxNumIters=60,
            ),
        )
        # classify from the driver's returned global weights
        tp = fp = fn = tn = 0
        for key, w in res.weights.items():
            rejected = w < 0.5
            if key in outlier_keys:
                tp += rejected
                fn += not rejected
            else:
                fp += rejected
                tn += not rejected
        rec["distributed"] = dict(
            tp=int(tp), fp=int(fp), fn=int(fn), tn=int(tn),
            precision=float(tp / max(tp + fp, 1)),
            recall=float(tp / max(tp + fn, 1)),
            certified=bool(res.certified),
            final_rank=int(res.final_rank),
            total_iters=int(res.total_iters),
            final_cost=res.cost_trace[-1] if res.cost_trace else None,
            elapsed_s=time.time() - t0,
        )
        # diagnose misclassifications: residual of each FP/FN edge at
        # the rounded final estimate, plus whether it crosses a robot
        # boundary (shared) — distinguishes "reclassify should have
        # caught it" (resid < barc) from "estimate drifted to a
        # self-consistent reduced-problem optimum" (resid >> barc)
        if fp or fn:
            from dcora_tpu.core.certify import round_solution

            Xr = round_solution(res.X)
            rot = np.asarray(Xr.rot)
            trn = np.asarray(Xr.trn)
            npp = ds.num_poses

            def blk(p):
                return min(p // max(npp // args.robots, 1),
                           args.robots - 1)

            details = []
            for m in corrupted:
                if m.fixedWeight:
                    continue
                key = (m.p1, m.p2)
                w = res.weights.get(key)
                if w is None:
                    continue
                is_fp = key not in outlier_keys and w < 0.5
                is_fn = key in outlier_keys and w >= 0.5
                if not (is_fp or is_fn):
                    continue
                Y1, Y2 = rot[m.p1], rot[m.p2]
                p1_, p2_ = trn[m.p1], trn[m.p2]
                err = (m.kappa * ((Y1 @ m.R - Y2) ** 2).sum()
                       + m.tau * ((p2_ - p1_ - Y1 @ m.t) ** 2).sum())
                details.append(dict(
                    key=list(key), w=float(w),
                    resid=float(np.sqrt(err)),
                    shared=bool(blk(m.p1) != blk(m.p2)),
                    kind="fp" if is_fp else "fn",
                ))
            rec["distributed"]["misclassified"] = details
            rs = [d["resid"] for d in details]
            print(json.dumps(dict(
                n_misclassified=len(details),
                n_shared=sum(d["shared"] for d in details),
                resid_min=min(rs), resid_max=max(rs),
                resid_median=float(np.median(rs)),
            )), flush=True)
        print(json.dumps({k: v for k, v in rec["distributed"].items()
                          if k != "misclassified"}), flush=True)

    rec["platform"] = jax.default_backend()
    rec["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, f"robust_{name}.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({k: v for k, v in rec.items()}, indent=1))


if __name__ == "__main__":
    main()
