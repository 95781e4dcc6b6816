"""Parity harness: run the reference's flagship configs end-to-end and
record independently-verified results as committed artifacts.

Because the reference binaries cannot be built here (network-fetched
ROPTLIB/Spectra/gtest + missing system Eigen/SuiteSparse; see
dcora_tpu/verification.py docstring), parity is established through the
certifiable-optimization protocol: a solution passing the scipy-assembled
dual-certificate check IS the global optimum of the same SDP relaxation
the reference certifies against (DCORA_utils.cpp:1898-1982).  For every
config this records: our engine's final cost, the independent scipy cost
under the incidence-matrix Q, the independent Riemannian gradient norm,
the independent certificate min-eig, rounded-solution cost, and ATE vs
the dataset ground truth (where the file embeds one).

Usage:
  python tools/parity.py --platform cpu --configs tinyGrid3D smallGrid3D
  python tools/parity.py --platform gpu --configs smallGrid3D

Configs read their files from --data-dir (default: the generated datasets
in .data_cache/); files with no generator must be supplied there.

Writes artifacts/parity/<name>.json; `--summary` regenerates the table in
BASELINE_CAPTURED.md from all recorded artifacts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

ART = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts",
                   "parity")

# reference driver configs being mirrored:
#   PGO: MultiRobotExample.cpp / SingleRobotExample.cpp (r_min=5, eta 1e-3)
#   RA:  SingleRobotExample_RASLAM.cpp (r_min=d, r_max=20, eta 1e-4)
CONFIGS = {
    "tinyGrid3D": dict(kind="pgo", file="tinyGrid3D.g2o", r_min=5,
                       r_max=10, eta=1e-3),
    "smallGrid3D": dict(kind="pgo", file="smallGrid3D.g2o", r_min=5,
                        r_max=10, eta=1e-3),
    "parking-garage": dict(kind="pgo", file="parking-garage.g2o", r_min=5,
                           r_max=12, eta=1e-3),
    "sphere2500": dict(kind="pgo", file="sphere2500.g2o", r_min=5,
                       r_max=12, eta=1e-3),
    "torus3D": dict(kind="pgo", file="torus3D.g2o", r_min=5, r_max=12,
                    eta=1e-3),
    "city10000": dict(kind="pgo", file="city10000.g2o", r_min=5, r_max=12,
                      eta=1e-3),
    # 2D PGO benchmarks (EDGE_SE2; same staircase, d=2)
    "CSAIL": dict(kind="pgo", file="CSAIL.g2o", r_min=5, r_max=12,
                  eta=1e-3),
    "kitti_00": dict(kind="pgo", file="kitti_00.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_02": dict(kind="pgo", file="kitti_02.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_05": dict(kind="pgo", file="kitti_05.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_06": dict(kind="pgo", file="kitti_06.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    # rtr_iters raised: the 200-outer budget stalled at gradnorm 3.9e-3
    # against eta=1e-3, leaving cert_slack above the claimed tolerance
    "kitti_07": dict(kind="pgo", file="kitti_07.g2o", r_min=5, r_max=12,
                     eta=1e-3, rtr_iters=600),
    "kitti_08": dict(kind="pgo", file="kitti_08.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "kitti_09": dict(kind="pgo", file="kitti_09.g2o", r_min=5, r_max=12,
                     eta=1e-3),
    "input_INTEL": dict(kind="pgo", file="input_INTEL_g2o.g2o", r_min=5,
                        r_max=12, eta=1e-3),
    # rtr_iters raised (see kitti_07): recorded indep gradnorm 1.19e-3
    # sits above eta, leaving the certificate on O(gradnorm) slack
    "input_M3500": dict(kind="pgo", file="input_M3500_g2o.g2o", r_min=5,
                        r_max=12, eta=1e-3, rtr_iters=600),
    "input_MITb": dict(kind="pgo", file="input_MITb_g2o.g2o", r_min=5,
                       r_max=12, eta=1e-3),
    # rtr_iters raised (see kitti_07): round-4 certified at gradnorm
    # 6.1e-3 > eta; the deeper budget drives cert_slack below tolerance
    "ais2klinik": dict(kind="pgo", file="ais2klinik.g2o", r_min=5,
                       r_max=12, eta=1e-3, rtr_iters=600),
    # 3D PGO benchmarks
    "sphere_bignoise": dict(kind="pgo", file="sphere_bignoise_vertex3.g2o",
                            r_min=5, r_max=12, eta=1e-3),
    "cubicle": dict(kind="pgo", file="cubicle.g2o", r_min=5, r_max=12,
                    eta=1e-3),
    # PyFG SE-only test data through the RA driver (l=0 degenerate case)
    "pyfg_se2_test": dict(kind="ra", file="pyfg_se2_test_data.pyfg",
                          r_max=20, eta=1e-4),
    "pyfg_se3_test": dict(kind="ra", file="pyfg_se3_test_data.pyfg",
                          r_max=20, eta=1e-4),
    "ra_slam_test_3d": dict(kind="ra", file="range_aided_slam_test_3d.pyfg",
                            r_max=20, eta=1e-4),
    "ra_slam_test_2d": dict(kind="ra", file="range_aided_slam_test_2d.pyfg",
                            r_max=20, eta=1e-4),
    "single_drone": dict(kind="ra", file="single_drone.pyfg", r_max=20,
                         eta=1e-4),
    "tiers": dict(kind="ra", file="tiers.pyfg", r_max=20, eta=1e-4),
    # num_iters raised from the demo's 1000: the sequential greedy RBCD
    # needs ~5k iterations to pass the PSD gradient-noise gate (10*eta)
    # once the adaptive stop tightens below the demo tol 0.1
    "multi_robot_smallGrid3D": dict(kind="dc2pgo", file="smallGrid3D.g2o",
                                    robots=5, r_min=5, r_max=10, eta=1e-3,
                                    num_iters=4000),
    # multi-robot DCORA (2 robots A/B in the file) — the distributed RA
    # path of MultiRobotExample_RASLAM.cpp.  Uses the demo stop tol 0.1
    # (MultiRobotExample_RASLAM.cpp:101): the adaptive RBCD->certificate
    # stop tightens it automatically when the dual certificate is
    # inconclusive within the O(gradnorm) slack.
    "multi_robot_ra_test_3d": dict(kind="dcora",
                                   file="range_aided_slam_test_3d.pyfg",
                                   r_max=10, eta=1e-3, tol=0.1),
}


def run_pgo(path, cfg):
    import numpy as np

    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.staircase import riemannian_staircase
    from dcora_tpu.types import ROptParameters

    ds = read_g2o_file(path)
    d = ds.dim
    g = LocalGraph(0, cfg["r_min"], d)
    g.set_measurements(ds.pose_pose_measurements)
    T0 = chordal_initialization(ds.pose_pose_measurements)
    X0 = lifted.pad_rank(lifted.from_pose_array(T0), cfg["r_min"])
    t0 = time.time()
    res = riemannian_staircase(
        g, X0, r_min=cfg["r_min"], r_max=cfg["r_max"],
        opt_params=ROptParameters(
            gradnorm_tol=cfg.get("gradnorm_tol", 1e-4),
            RTR_iterations=cfg.get("rtr_iters", 200),
            RTR_tCG_iterations=cfg.get("tcg_iters", 200),
        ),
        min_eig_num_tol=cfg["eta"], verbose=True,
    )
    elapsed = time.time() - t0
    P = g.problem_data()
    f_rounded = float(prob.cost(P, res.rounded))
    T_est = np.asarray(
        np.concatenate(
            [np.asarray(res.rounded.rot),
             np.asarray(res.rounded.trn[: g.n])[:, :, None]], axis=2
        )
    )
    T_gt = (np.stack([np.asarray(ds.ground_truth_poses[k])
                      for k in sorted(ds.ground_truth_poses)])
            if ds.ground_truth_poses else None)
    return dict(
        measurements=ds.pose_pose_measurements, X=res.X, d=d,
        result=dict(
            certified=bool(res.certified), final_rank=int(res.final_rank),
            f_final=float(res.f_final), f_rounded=f_rounded,
            elapsed_s=elapsed,
            gradnorm_final=float(res.gradnorm_final),
            cert_slack=float(res.cert_slack),
        ),
        T_est=T_est, T_gt=T_gt,
    )


def run_ra(path, cfg):
    import numpy as np

    from dcora_tpu.core import problem as prob
    from dcora_tpu.drivers.single_robot_raslam import run as run_cora
    from dcora_tpu.io.remap import get_global_measurements
    from dcora_tpu.io import read_pyfg_file

    t0 = time.time()
    # long staircases (tiers: 9769 vertices) survive preemption through
    # the staircase checkpoint; resume = re-run the same command
    ckpt = os.path.join(STATE_DIR, f"ckpt_{os.path.basename(path)}.npz")
    os.makedirs(STATE_DIR, exist_ok=True)
    res, g, gm = run_cora(path, r_max=cfg["r_max"],
                          min_eig_tol=cfg["eta"], verbose=True,
                          checkpoint_path=ckpt)
    elapsed = time.time() - t0
    ds = read_pyfg_file(path)
    gm2 = get_global_measurements(ds)
    gt = gm2.ground_truth_init
    d = ds.dim
    P = g.problem_data()
    f_rounded = float(prob.cost(P, res.rounded))
    T_est = np.concatenate(
        [np.asarray(res.rounded.rot),
         np.asarray(res.rounded.trn[: g.n])[:, :, None]], axis=2
    )
    T_gt = np.concatenate(
        [np.asarray(gt.rot), np.asarray(gt.trn[: g.n])[:, :, None]], axis=2
    )
    return dict(
        measurements=gm.relative_measurements, X=res.X, d=d,
        result=dict(
            certified=bool(res.certified), final_rank=int(res.final_rank),
            f_final=float(res.f_final), f_rounded=f_rounded,
            elapsed_s=elapsed,
            gradnorm_final=float(res.gradnorm_final),
            cert_slack=float(res.cert_slack),
        ),
        T_est=T_est, T_gt=T_gt,
    )


def run_dc2pgo(path, cfg):
    import numpy as np

    from dcora_tpu.drivers.multi_robot_pgo import run as run_mr
    from dcora_tpu.io import read_g2o_file

    ds = read_g2o_file(path)
    t0 = time.time()
    res = run_mr(cfg["robots"], path, r_min=cfg["r_min"],
                 r_max=cfg["r_max"], min_eig_num_tol=cfg["eta"],
                 num_iters=cfg.get("num_iters", 1000))
    elapsed = time.time() - t0
    T_gt = (np.stack([np.asarray(ds.ground_truth_poses[k])
                      for k in sorted(ds.ground_truth_poses)])
            if ds.ground_truth_poses else None)
    return dict(
        measurements=ds.pose_pose_measurements, X=res.X, d=ds.dim,
        result=dict(
            certified=bool(res.certified), final_rank=int(res.final_rank),
            f_final=(res.cost_trace[-1] if res.cost_trace else None),
            total_iters=int(res.total_iters), elapsed_s=elapsed,
            gradnorm_final=(res.gradnorm_trace[-1]
                            if res.gradnorm_trace else None),
            final_theta=res.final_theta, cert_slack=res.cert_slack,
        ),
        T_est=None, T_gt=T_gt,
        cost_trace=res.cost_trace, gradnorm_trace=res.gradnorm_trace,
    )


def run_dcora(path, cfg):
    import numpy as np

    from dcora_tpu.drivers.multi_robot_raslam import run as run_mr_ra
    from dcora_tpu.io.remap import get_global_measurements
    from dcora_tpu.io import read_pyfg_file

    t0 = time.time()
    res = run_mr_ra(path, r_max=cfg["r_max"],
                    min_eig_num_tol=cfg["eta"],
                    rgrad_norm_tol=cfg.get("tol", 0.1))
    elapsed = time.time() - t0
    ds = read_pyfg_file(path)
    gm = get_global_measurements(ds)
    return dict(
        measurements=gm.relative_measurements, X=res.X, d=ds.dim,
        result=dict(
            certified=bool(res.certified), final_rank=int(res.final_rank),
            f_final=(res.cost_trace[-1] if res.cost_trace else None),
            total_iters=int(res.total_iters), elapsed_s=elapsed,
            gradnorm_final=(res.gradnorm_trace[-1]
                            if res.gradnorm_trace else None),
            final_theta=res.final_theta, cert_slack=res.cert_slack,
        ),
        T_est=None, T_gt=None,
        cost_trace=res.cost_trace, gradnorm_trace=res.gradnorm_trace,
    )


STATE_DIR = os.path.join(ART, "state")  # gitignored npz of final X


def _save_state(name, X):
    import numpy as np

    os.makedirs(STATE_DIR, exist_ok=True)
    np.savez_compressed(
        os.path.join(STATE_DIR, f"{name}.npz"),
        rot=np.asarray(X.rot), sph=np.asarray(X.sph),
        trn=np.asarray(X.trn),
    )


def _load_state(name):
    import numpy as np

    from dcora_tpu.core.lifted import RAState

    z = np.load(os.path.join(STATE_DIR, f"{name}.npz"))
    return RAState(rot=z["rot"], sph=z["sph"], trn=z["trn"])


def _downsample(trace, keep=400):
    """Bound committed artifact size: keep every Nth point plus the final
    value (a 4000-iteration run once inserted 33k JSON lines)."""
    trace = [float(x) for x in trace]
    if len(trace) <= keep:
        return trace
    step = -(-len(trace) // keep)
    out = trace[::step]
    if out[-1] != trace[-1]:
        out.append(trace[-1])
    return out


def _config_measurements(name, data_dir):
    """The measurement list verify_solution needs, per config kind."""
    cfg = CONFIGS[name]
    path = os.path.join(data_dir, cfg["file"])
    if cfg["kind"] in ("pgo", "dc2pgo"):
        from dcora_tpu.io import read_g2o_file

        return read_g2o_file(path).pose_pose_measurements
    from dcora_tpu.io import read_pyfg_file
    from dcora_tpu.io.remap import get_global_measurements

    return get_global_measurements(read_pyfg_file(path)).relative_measurements


def reverify_config(name, data_dir):
    """Re-run ONLY the independent verification against the saved final
    state and update the artifact's verification fields in place (used
    after verifier fixes, so sound verdicts don't require re-solving)."""
    from dcora_tpu.io import read_g2o_file, read_pyfg_file  # noqa: F401
    from dcora_tpu import verification as V

    cfg = CONFIGS[name]
    ms = _config_measurements(name, data_dir)
    X = _load_state(name)
    with open(os.path.join(ART, f"{name}.json")) as fh:
        rec = json.load(fh)
    t_v = time.time()
    rep = V.verify_solution(ms, X, X.d, eta=cfg["eta"])
    rep["verify_indep_s"] = time.time() - t_v
    rec.update(rep)
    rec["reverified_timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    with open(os.path.join(ART, f"{name}.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def run_config(name, data_dir):
    cfg = CONFIGS[name]
    path = os.path.join(data_dir, cfg["file"])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if cfg["kind"] == "pgo":
        out = run_pgo(path, cfg)
    elif cfg["kind"] == "ra":
        out = run_ra(path, cfg)
    elif cfg["kind"] == "dcora":
        out = run_dcora(path, cfg)
    else:
        out = run_dc2pgo(path, cfg)

    _save_state(name, out["X"])

    from dcora_tpu import verification as V

    t_v = time.time()
    rep = V.verify_solution(out["measurements"], out["X"], out["d"],
                            eta=cfg["eta"])
    rep["verify_indep_s"] = time.time() - t_v
    rec = dict(cfg=dict(cfg), **out["result"], **rep)
    if out.get("T_est") is not None and out.get("T_gt") is not None \
            and len(out["T_est"]) == len(out["T_gt"]):
        rec["ate_vs_gt"] = V.ate_vs_ground_truth(out["T_est"], out["T_gt"])
    if "cost_trace" in out:
        rec["cost_trace"] = _downsample(out["cost_trace"])
        rec["gradnorm_trace"] = _downsample(out["gradnorm_trace"])
    rec["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")
    import jax

    rec["platform"] = jax.default_backend()
    return rec


_CAPTURED_HEADER = """# BASELINE_CAPTURED — reference-parity evidence

**Why this protocol.** The reference binaries cannot be built in this
sandbox: their cmake FetchContent pulls ROPTLIB/Spectra/gtest from GitHub
at configure time (cmake/roptlib.cmake:6, cmake/spectra.cmake:5,
cmake/gtest.cmake:7) and the system lacks Eigen/SuiteSparse/Boost/glog;
there is no network egress.  Certifiable optimization supplies a stronger,
falsifiable substitute for trace-matching: the rank-restricted SDP
relaxation both codebases solve has a *unique certified global optimum*,
and both certify against the same dual matrix S = Q - Lambda(X)
(DCORA_utils.cpp:1898-1982).  Every row below therefore records, for a
reference flagship config (README.md:20-27, examples/*.cpp):

* the engine's final cost and certification verdict, and
* an **independent scipy re-verification** (dcora_tpu/verification.py:
  incidence-matrix Q per Graph.cpp:579-683/:824-1188, numpy tangent
  projections, ARPACK/LOBPCG min-eig of S) that shares no code with the
  JAX engine.

A solution that passes the independent certificate check IS the optimum
the reference computes; matching `f*` across both Q constructions to all
printed digits rules out cost-convention drift.  The *LDL witness*
column is the certification basis: `certified (scipy)` is True ONLY
when an LDL^T inertia factorization proves S + eta*I >= 0 (True in that
column); eigensolver estimates never certify (they locate SOME eigenpair,
not provably the bottom one — the tiers.pyfg false-certification class).
Cost convention: the
multi-robot rows report the reference's printed scale 2*f
(MultiRobotExample.cpp:280); single-robot rows report f = 0.5<XQ,X>.
ATE is Umeyama-aligned RMSE vs the dataset's embedded vertex estimates
(for noisy g2o benchmarks these are initializations, so nonzero ATE there
reflects the dataset, not suboptimality; the certificate is the
optimality evidence).

Regenerate with:  python tools/parity.py --summary  (artifacts in
artifacts/parity/*.json; each was produced by tools/parity.py running the
full staircase + rounding + independent verification).

"""


def summarize():
    rows = []
    for f in sorted(os.listdir(ART)):
        if f.endswith(".json"):
            with open(os.path.join(ART, f)) as fh:
                rec = json.load(fh)
            rows.append((f[:-5], rec))
    lines = [
        "| config | platform | certified (engine) | certified (scipy) | "
        "LDL witness | rank | f* | f* (scipy Q) | indep gradnorm | "
        "indep min-eig | ATE vs GT | wall s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, r in rows:
        ate = r.get("ate_vs_gt")
        f_final = r.get("f_final")
        lines.append(
            f"| {name} | {r.get('platform','?')} | "
            f"{r.get('certified')} | {r.get('certified_indep')} | "
            f"{r.get('psd_proof_indep')} | "
            f"{r.get('final_rank')} | "
            f"{f_final if f_final is None else f'{f_final:.6f}'} | "
            f"{r['f_indep']:.6f} | {r['gradnorm_indep']:.2e} | "
            f"{r['min_eig_indep']:.2e} | "
            f"{'—' if ate is None else f'{ate:.4f}'} | "
            f"{r.get('elapsed_s', 0):.1f} |"
        )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=[])
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--data-dir", default=os.path.join(
        os.path.dirname(__file__), os.pardir, ".data_cache"))
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--reverify", action="store_true",
                    help="re-run ONLY the independent verification of the "
                    "named configs against their saved final states")
    args = ap.parse_args()

    if args.summary:
        table = summarize()
        out = os.path.join(os.path.dirname(__file__), os.pardir,
                           "BASELINE_CAPTURED.md")
        with open(out, "w") as fh:
            fh.write(_CAPTURED_HEADER + table + "\n")
        print(table)
        return

    import logging

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s")

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import dcora_tpu  # noqa: F401  (x64 + cache setup)

    os.makedirs(ART, exist_ok=True)
    if args.reverify:
        for name in args.configs:
            print(f"=== reverify {name} ===", flush=True)
            rec = reverify_config(name, args.data_dir)
            print(json.dumps({k: v for k, v in rec.items()
                              if k not in ("cost_trace",
                                           "gradnorm_trace")},
                             indent=1), flush=True)
        return
    for name in args.configs:
        print(f"=== {name} ===", flush=True)
        rec = run_config(name, args.data_dir)
        with open(os.path.join(ART, f"{name}.json"), "w") as fh:
            json.dump(rec, fh, indent=1)
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("cost_trace", "gradnorm_trace")},
                         indent=1), flush=True)


if __name__ == "__main__":
    main()
