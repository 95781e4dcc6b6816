"""Centralized CORA: single-robot RA-SLAM via the Riemannian staircase.

Mirrors examples/SingleRobotExample_RASLAM.cpp: read PyFG, build the global
RA problem, odometry init aligned per robot to its ground-truth first pose +
ground-truth unit spheres + random landmarks, staircase r = d .. r_max with
certification, then rank-d rounding and refinement.

Usage: python -m dcora_tpu.drivers.single_robot_raslam data.pyfg [--rmax 20]
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

import dcora_tpu  # noqa: F401  (enables x64)
from dcora_tpu.core import lifted, manifold, problem as prob
from dcora_tpu.core.graph import LocalGraph
from dcora_tpu.core.init import odometry_initialization
from dcora_tpu.core.lifted import RAState, pose_inverse, pose_multiply
from dcora_tpu.io import read_pyfg_file
from dcora_tpu.io.remap import (
    get_global_measurements,
    get_local_to_global_state_mapping,
    get_robot_measurements,
)
from dcora_tpu.measurements import RelativePosePoseMeasurement
from dcora_tpu.staircase import riemannian_staircase
from dcora_tpu.types import MAP_ID, GraphType, PoseID, ROptParameters
from dcora_tpu.utils.timing import PhaseTimer

logger = logging.getLogger(__name__)


def align_trajectory_to_frame(T: np.ndarray, Tw0: np.ndarray) -> np.ndarray:
    """T0i = Tw0^{-1} * Twi for every pose
    (reference: alignTrajectoryToFrame, DCORA_utils.cpp:2222-2235)."""
    inv = pose_inverse(Tw0)
    return np.stack([pose_multiply(inv, Ti) for Ti in T])


def odometry_init_global(ds, global_meas) -> RAState:
    """Per-robot odometry chained then aligned to the ground truth first
    pose; ground-truth unit spheres; random landmarks
    (reference: SingleRobotExample_RASLAM.cpp:88-152)."""
    mapping = get_local_to_global_state_mapping(ds)
    robot_meas = get_robot_measurements(ds)
    gt = global_meas.ground_truth_init
    d = ds.dim
    n, l, b = gt.n, gt.l, gt.b

    T = np.zeros((n, d, d + 1))
    for robot in sorted(ds.robot_IDs):
        if robot == MAP_ID:
            continue
        rm = robot_meas[robot]
        odo = [
            m
            for m in rm.relative_measurements
            if isinstance(m, RelativePosePoseMeasurement)
            and m.p1 + 1 == m.p2 and m.r1 == m.r2 == robot
        ]
        n_r = ds.robot_id_to_num_poses[robot]
        if not odo:
            Todo = np.zeros((n_r, d, d + 1))
            Todo[:, :, :d] = np.eye(d)
        else:
            Todo = odometry_initialization(odo)
        first_global = mapping.poses[PoseID(robot, 0)].frame_id
        Tw0 = np.concatenate(
            [np.asarray(gt.rot[first_global]),
             np.asarray(gt.trn[first_global])[:, None]], axis=1
        )
        # align odometry so its first pose coincides with ground truth:
        # reference aligns with Tw0.inverse(), i.e. T_i <- Tw0 * T_i
        aligned = np.stack([pose_multiply(Tw0, Ti) for Ti in Todo])
        T[first_global : first_global + n_r] = aligned[:n_r]

    rng = np.random.default_rng(0)
    lmks = rng.uniform(-1, 1, size=(b, d))
    sphs = np.asarray(gt.sph)
    return lifted.from_pose_array(T, l=l, b=b, landmarks=lmks, spheres=sphs)


def run(pyfg_path: str, r_max: int = 20, min_eig_tol: float = 1e-4,
        init: str = "odometry", verbose: bool = True,
        checkpoint_path: str = None, timer: PhaseTimer = None):
    """Returns (StaircaseResult, LocalGraph, global measurements);
    ``timer`` collects the wall time of each stage (parse, init, then the
    staircase's)."""
    timer = timer if timer is not None else PhaseTimer()
    with timer.phase("parse"):
        ds = read_pyfg_file(pyfg_path)
        gm = get_global_measurements(ds)
    d = ds.dim
    gt = gm.ground_truth_init

    g = LocalGraph(0, d, d, GraphType.RangeAidedSLAMGraph)
    g.set_measurements(gm.relative_measurements)

    with timer.phase("init"):
        if init == "odometry":
            X0 = odometry_init_global(ds, gm)
        elif init == "ground_truth":
            X0 = gt
        else:
            import jax.random as jr

            X0 = manifold.random_state(jr.PRNGKey(0), g.dims, d)

    t0 = time.time()
    res = riemannian_staircase(
        g, X0, r_min=d, r_max=r_max,
        opt_params=ROptParameters(
            gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200
        ),
        min_eig_num_tol=min_eig_tol, verbose=verbose,
        checkpoint_path=checkpoint_path, timer=timer,
    )
    P = g.problem_data()
    f_rounded = float(prob.cost(P, res.rounded))
    if verbose:
        print(
            f"CORA: certified={res.certified} rank={res.final_rank} "
            f"f={res.f_final:.6f} f_rounded={f_rounded:.6f} "
            f"elapsed={time.time() - t0:.1f}s"
        )
    return res, g, gm


def main():
    from dcora_tpu.config import DcoraConfig, resolve

    ap = argparse.ArgumentParser()
    ap.add_argument("pyfg")
    ap.add_argument("--rmax", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--init", default="odometry",
                    choices=["odometry", "ground_truth", "random"])
    DcoraConfig.add_cli(ap)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    # the centralized CORA demo's tolerance is 1e-4
    # (SingleRobotExample_RASLAM.cpp:77), tighter than the distributed
    # default carried by the config
    logger.info("config:\n%s", cfg.dump())
    run(args.pyfg, resolve(args.rmax, min(cfg.staircase.r_max, 20)),
        resolve(args.eta, 1e-4), args.init)


if __name__ == "__main__":
    main()
