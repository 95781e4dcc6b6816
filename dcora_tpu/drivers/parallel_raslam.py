"""Scaling-mode DCORA: synchronous-parallel RBCD for RA-SLAM over a mesh.

The device-parallel counterpart of the sequential greedy RA driver
(multi_robot_raslam.py / MultiRobotExample_RASLAM.cpp:282-453): per-robot
RA blocks (lifted poses + unit spheres + landmarks) all update concurrently
against their neighbors' previous-round public states; the three-dict
public-state exchange of the reference (pose/unit-sphere/landmark,
MultiRobotExample_RASLAM.cpp:303-337) becomes one all_gather of padded
separator buffers over the mesh axis per round (parallel/rbcd.py carries
the sphere/landmark machinery: fix_sph_src / pub_sph_idx / range remaps).

Single-chip / CPU virtual-device usage:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m dcora_tpu.drivers.parallel_raslam data.pyfg --cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

import dcora_tpu  # noqa: F401


def run(pyfg_path: str, r: int = 0, max_rounds: int = 1000,
        rgrad_norm_tol: float = 0.1, check_every: int = 10,
        verbose: bool = False, backend: str = "auto", tile_dtype=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.core.rtr import RTRConfig, riemannian_gradient
    from dcora_tpu.drivers.multi_robot_raslam import (
        _scatter_agent_state,
        _slice_agent_state,
    )
    from dcora_tpu.drivers.single_robot_raslam import odometry_init_global
    from dcora_tpu.io import read_pyfg_file
    from dcora_tpu.io.remap import (
        get_global_measurements,
        get_robot_measurements,
        robot_global_indices,
    )
    from dcora_tpu.parallel.rbcd import (
        build_parallel_problem,
        make_parallel_round,
        pack_states,
        unpack_states,
    )
    from dcora_tpu.types import GraphType, MAP_ID

    t0 = time.time()
    ds = read_pyfg_file(pyfg_path)
    gm = get_global_measurements(ds)
    robot_meas = get_robot_measurements(ds)
    ridx = robot_global_indices(ds)
    d = ds.dim
    r = r or d  # reference staircase starts at r_min = d (:66)
    gt = gm.ground_truth_init
    n, l, b = gt.n, gt.l, gt.b  # noqa: E741

    # the map agent owns nothing and is rejected by the reference driver
    # (MultiRobotExample_RASLAM.cpp:37-42)
    active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
    A = len(active)
    devices = jax.devices()
    assert len(devices) >= A, (
        f"need {A} devices, have {len(devices)} "
        "(use XLA_FLAGS=--xla_force_host_platform_device_count=N)"
    )
    mesh = Mesh(np.array(devices[:A]), ("agents",))

    graphs: List[LocalGraph] = []
    for rid in active:
        g = LocalGraph(rid, r, d, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(robot_meas[rid].relative_measurements)
        graphs.append(g)

    X0 = odometry_init_global(ds, gm)
    if X0.r < r:
        X0 = lifted.pad_rank(X0, r)
    states = [_slice_agent_state(X0, ridx[rid]) for rid in active]

    # "auto": dense-tile f32 block updates on the GPU, exact f64 edge path
    # on CPU (as in parallel_pgo)
    if backend == "auto":
        backend = "tiled" if jax.default_backend() not in ("cpu",) \
            else "edge"
    if tile_dtype is None:
        tile_dtype = (np.float32 if jax.default_backend() != "cpu"
                      else np.float64)
    agent_of_robot = {rid: i for i, rid in enumerate(active)}
    pp = build_parallel_problem(graphs, agent_of_robot=agent_of_robot,
                                backend=backend, tile_dtype=tile_dtype)
    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    round_fn = make_parallel_round(pp, cfg, mesh)

    central = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
    central.set_measurements(gm.relative_measurements)
    P = central.problem_data()
    G0 = lifted.zeros(central.dims, r)

    def global_state(Xb) -> RAState:
        parts = unpack_states(pp, Xb)
        rot = np.zeros((n, r, d))
        sph = np.zeros((l, r))
        trn = np.zeros((n + b, r))
        for a, rid in enumerate(active):
            _scatter_agent_state((rot, sph, trn), parts[a], ridx[rid], n)
        return RAState(rot=jnp.asarray(rot), sph=jnp.asarray(sph),
                       trn=jnp.asarray(trn))

    Xb = pack_states(pp, states)
    gradnorm = float("inf")
    cost = float("nan")
    rounds = 0
    for it in range(max_rounds):
        Xb, gnorms = round_fn(Xb)
        rounds += 1
        if it % check_every == 0 or it == max_rounds - 1:
            Xg = global_state(Xb)
            cost = 2.0 * float(prob.cost(P, Xg))
            gradnorm = float(riemannian_gradient(P, Xg, G0).norm())
            if verbose:
                print(f"round = {it} | cost = {cost:.6f} | "
                      f"gradnorm = {gradnorm:.4f}")
            if gradnorm < rgrad_norm_tol:
                break

    Xg = global_state(Xb)
    cost = 2.0 * float(prob.cost(P, Xg))
    elapsed = time.time() - t0
    print(f"parallel-DCORA: agents={A} rounds={rounds} cost={cost:.6f} "
          f"gradnorm={gradnorm:.4f} elapsed={elapsed:.1f}s "
          f"({rounds * (n + l + b) / max(elapsed, 1e-9):.0f} "
          "state-updates/s)")
    return Xg, cost, gradnorm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pyfg")
    ap.add_argument("--rank", type=int, default=0,
                    help="relaxation rank (default: d)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "edge", "tiled"])
    ap.add_argument("--verbose", action="store_true")
    from dcora_tpu.config import DcoraConfig, resolve

    DcoraConfig.add_cli(ap)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    cfg = DcoraConfig.from_cli(args)
    import logging

    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    run(args.pyfg, r=args.rank,
        max_rounds=resolve(args.rounds, cfg.rbcd.num_iters),
        rgrad_norm_tol=resolve(args.tol, cfg.rbcd.rgrad_norm_tol),
        verbose=args.verbose, backend=args.backend)


if __name__ == "__main__":
    main()
