"""Single-robot local PGO (mirrors examples/SingleRobotExample.cpp).

Chordal initialization followed by a full Riemannian trust-region solve at
rank d, with optional staircase certification of global optimality.

Usage: python -m dcora_tpu.drivers.single_robot_pgo file.g2o [--certify]
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

import dcora_tpu  # noqa: F401
from dcora_tpu.core import lifted, problem as prob
from dcora_tpu.core.graph import LocalGraph
from dcora_tpu.core.init import chordal_initialization
from dcora_tpu.io import read_g2o_file
from dcora_tpu.solvers import solve_pgo
from dcora_tpu.staircase import riemannian_staircase
from dcora_tpu.types import ROptParameters
from dcora_tpu.utils.logger import Logger
from dcora_tpu.utils.timing import PhaseTimer


def run(g2o_path: str, certify: bool = False, log_directory: str = "",
        verbose: bool = True, opt_params: ROptParameters = None,
        r_max: int = 20, eta: float = 1e-3,
        timer: PhaseTimer = None):
    """Solve one g2o file.  Returns (T_out [n, d, d+1], f, res) with res
    the StaircaseResult when certify=True, else None.  ``timer`` collects
    the wall time of each stage (parse, init, then the staircase's)."""
    timer = timer if timer is not None else PhaseTimer()
    with timer.phase("parse"):
        ds = read_g2o_file(g2o_path)
    ms = ds.pose_pose_measurements
    d = ds.dim
    t0 = time.time()
    params = opt_params or ROptParameters(
        gradnorm_tol=1e-4, RTR_iterations=200, RTR_tCG_iterations=200
    )
    res = None
    if certify:
        g = LocalGraph(0, d + 2, d)
        g.set_measurements(ms)
        with timer.phase("init"):
            T = chordal_initialization(ms)
        X0 = lifted.pad_rank(lifted.from_pose_array(T), d + 2)
        res = riemannian_staircase(
            g, X0, r_min=d + 2, r_max=min(r_max, 20), opt_params=params,
            min_eig_num_tol=eta, timer=timer,
        )
        T_out = np.zeros((g.n, d, d + 1))
        T_out[:, :, :d] = np.asarray(res.rounded.rot)
        T_out[:, :, d] = np.asarray(res.rounded.trn)
        f = float(prob.cost(g.problem_data(), res.rounded))
        if verbose:
            print(
                f"solvePGO: certified={res.certified} "
                f"rank={res.final_rank} f={f:.6f} "
                f"elapsed={time.time() - t0:.1f}s"
            )
    else:
        T_out = solve_pgo(ms, params)
        g = LocalGraph(0, d, d)
        g.set_measurements(ms)
        f = float(prob.cost(g.problem_data(),
                            lifted.from_pose_array(T_out)))
        if verbose:
            print(f"solvePGO: f={f:.6f} elapsed={time.time() - t0:.1f}s")
    if log_directory:
        Logger(log_directory).log_trajectory(
            d, len(T_out), T_out, "dcora_A.txt"
        )
    return T_out, f, res


def main():
    from dcora_tpu.config import DcoraConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("g2o")
    ap.add_argument("--certify", action="store_true")
    ap.add_argument("--log-dir", default="")
    DcoraConfig.add_cli(ap)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    run(args.g2o, certify=args.certify, log_directory=args.log_dir,
        opt_params=cfg.ropt, r_max=cfg.staircase.r_max,
        eta=cfg.staircase.min_eig_num_tol)


if __name__ == "__main__":
    main()
