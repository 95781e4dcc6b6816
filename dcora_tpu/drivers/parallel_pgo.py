"""Scaling-mode DC2-PGO: synchronous-parallel RBCD over a device mesh.

The device-parallel counterpart of the sequential greedy RBCD driver
(multi_robot_pgo.py / MultiRobotExample.cpp): every agent block updates
concurrently against its neighbors' previous-round public states, with the
separator exchange as one all_gather over the mesh axis per round
(SURVEY.md 2.3). Both schemes converge to first-order critical points of
the same block-separable lifted cost; this one maps to hardware.

On a single-device or CPU setup, run with virtual devices:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m dcora_tpu.drivers.parallel_pgo 8 file.g2o --cpu

On a multi-GPU host the mesh spans the cards and XLA hands the all_gather
to NCCL. For multi-host runs, every process launches the same
command with --coordinator/--num-processes/--process-id (or the
JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars):
jax.distributed.initialize wires the global mesh, the batched problem is
sharded over all processes' devices via jax.make_array_from_callback (no
cross-host data transfer — every host parses the same file), and
convergence uses a psum-reduced block-gradient-norm (the central
evaluation problem is only assembled on fully-addressable setups).

Two-process CPU smoke test: tests/test_multihost.py.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List

import numpy as np

import dcora_tpu  # noqa: F401


def init_multihost(coordinator: str, num_processes: int, process_id: int):
    """Initialize the JAX distributed runtime (multi-host over DCN).

    Must run before any jax computation. The same call serves multi-GPU
    hosts and the CPU test harness (gRPC coordination service at
    ``coordinator``)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def run(num_agents: int, g2o_path: str, r: int = 5, max_rounds: int = 1000,
        rgrad_norm_tol: float = 0.1, check_every: int = 10,
        verbose: bool = False, backend: str = "auto",
        tile_dtype=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.core.rtr import RTRConfig, riemannian_gradient
    from dcora_tpu.drivers.multi_robot_pgo import (
        partition_measurements,
        robot_slice,
    )
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.parallel.rbcd import (
        build_parallel_problem,
        globalize,
        make_parallel_round,
        pack_states,
        pack_states_global,
        unpack_states,
    )

    t0 = time.time()
    ds = read_g2o_file(g2o_path)
    ms = ds.pose_pose_measurements
    d, n = ds.dim, ds.num_poses

    multihost = jax.process_count() > 1
    devices = jax.devices()  # global device list across all processes
    assert len(devices) >= num_agents, (
        f"need {num_agents} devices, have {len(devices)} "
        "(use XLA_FLAGS=--xla_force_host_platform_device_count=N)"
    )
    mesh = Mesh(np.array(devices[:num_agents]), ("agents",))

    odo, priv, shared, _ = partition_measurements(ms, n, num_agents)
    graphs: List[LocalGraph] = []
    for a in range(num_agents):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)

    T = chordal_initialization(ms)
    X = lifted.pad_rank(lifted.from_pose_array(T), r)
    states = []
    for a in range(num_agents):
        s, e = robot_slice(n, num_agents, a)
        states.append(RAState(rot=X.rot[s:e], sph=X.sph[:0],
                              trn=X.trn[s:e]))

    # backend: "tiled" runs each block update on the dense-tile SpMM path
    # (f32 tiles on the GPU, f64 on CPU); "edge" is the exact f64
    # gather/scatter path; "auto" picks tiled on the GPU, edge on CPU.
    if backend == "auto":
        backend = "tiled" if jax.default_backend() not in ("cpu",) \
            else "edge"
    if tile_dtype is None:
        tile_dtype = (np.float32 if jax.default_backend() != "cpu"
                      else np.float64)
    pp = build_parallel_problem(graphs, backend=backend,
                                tile_dtype=tile_dtype)
    pp = globalize(pp, mesh)
    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    round_fn = make_parallel_round(pp, cfg, mesh)

    # psum-reduced convergence metric, replicated so every process reads it
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    gnorm_sum = jax.jit(
        lambda g: jnp.sqrt(jnp.sum(g ** 2)),
        out_shardings=NamedSharding(mesh, PSpec()),
    )

    if not multihost:
        central = LocalGraph(0, r, d)
        central.set_measurements(ms)
        P = central.problem_data()
        G0 = lifted.zeros(central.dims, r)

    def global_state(Xb):
        parts = unpack_states(pp, Xb)
        return RAState(
            rot=jnp.concatenate([s.rot for s in parts]),
            sph=jnp.zeros((0, r)),
            trn=jnp.concatenate([s.trn for s in parts]),
        )

    Xb = (pack_states_global(pp, states, mesh) if multihost
          else pack_states(pp, states))
    gradnorm = float("inf")
    rounds = 0
    for it in range(max_rounds):
        Xb, gnorms = round_fn(Xb)
        rounds += 1
        if it % check_every == 0 or it == max_rounds - 1:
            if multihost:
                # block-gradnorm reduction only: the central evaluation
                # problem needs fully-addressable state
                gradnorm = float(gnorm_sum(gnorms))
                cost = float("nan")
            else:
                Xg = global_state(Xb)
                cost = 2.0 * float(prob.cost(P, Xg))
                gradnorm = float(riemannian_gradient(P, Xg, G0).norm())
            if verbose:
                print(f"round = {it} | cost = {cost:.6f} | "
                      f"gradnorm = {gradnorm:.4f}")
            if gradnorm < rgrad_norm_tol:
                break

    if multihost:
        from jax.experimental import multihost_utils

        # gather the full block state onto every host for the trajectory
        Xb = jax.tree.map(
            lambda x: multihost_utils.process_allgather(x, tiled=True)
            if not x.is_fully_addressable else x, Xb,
        )
        cost = float("nan")
        Xg = None
    else:
        Xg = global_state(Xb)
        cost = 2.0 * float(prob.cost(P, Xg))
    elapsed = time.time() - t0
    print(f"parallel-RBCD: agents={num_agents} rounds={rounds} "
          f"cost={cost:.6f} gradnorm={gradnorm:.4f} elapsed={elapsed:.1f}s "
          f"({rounds * n / max(elapsed, 1e-9):.0f} pose-updates/s)")
    return Xg, cost, gradnorm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("num_agents", type=int)
    ap.add_argument("g2o")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual devices)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "edge", "tiled"],
                    help="block-update compute path (tiled = dense-tile "
                    "SpMM)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--coordinator",
                    default=os.environ.get("JAX_COORDINATOR", ""),
                    help="multi-host coordinator address host:port")
    ap.add_argument("--num-processes", type=int,
                    default=int(os.environ.get("JAX_NUM_PROCESSES", "0")))
    ap.add_argument("--process-id", type=int,
                    default=int(os.environ.get("JAX_PROCESS_ID", "-1")))
    from dcora_tpu.config import DcoraConfig, resolve

    DcoraConfig.add_cli(ap)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.coordinator and args.num_processes > 1:
        init_multihost(args.coordinator, args.num_processes,
                       args.process_id)
    cfg = DcoraConfig.from_cli(args)
    logging.getLogger(__name__).info("config:\n%s", cfg.dump())
    run(args.num_agents, args.g2o,
        r=resolve(args.rank, cfg.staircase.r_min),
        max_rounds=resolve(args.rounds, cfg.rbcd.num_iters),
        rgrad_norm_tol=resolve(args.tol, cfg.rbcd.rgrad_norm_tol),
        verbose=args.verbose, backend=args.backend)


if __name__ == "__main__":
    main()
