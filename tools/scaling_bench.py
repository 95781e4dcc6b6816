"""Parallel-RBCD scaling benchmark.

Measures synchronous-parallel RBCD round throughput over a device mesh at
a sweep of agent/device counts, and reports strong-scaling efficiency
(BASELINE.json north star: >=70% at N>=2 hosts on a g2o100k-class
problem).  The same harness serves three setups:

  * multi-GPU host: the mesh spans the cards, all_gather through NCCL
  * multi-host: launch one process per host with
    --coordinator/--num-processes/--process-id (jax.distributed)
  * CPU virtual mesh (--cpu + XLA_FLAGS=--xla_force_host_platform_
    device_count=N): validates the sweep mechanically; its *timing* is not
    a scaling signal (virtual devices share the host cores), which the
    emitted JSON marks with "timing_meaningful": false.

Usage:
  python tools/scaling_bench.py --dataset g2o100k --agents 1 2 4 8 \
      --rounds 20 [--cpu]

Writes artifacts/scaling_<dataset>.json:
  {"dataset", "platform", "num_devices", "sweep": [
     {"agents", "rounds_per_s", "pose_updates_per_s", "efficiency"}, ...]}

efficiency at A agents = T(1) / (A * T(A)) per round with the SAME total
problem (strong scaling): perfect sharding with free collectives gives
1.0; values >= 0.7 meet the BASELINE.json bar.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

ART = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")


def get_dataset(name: str, data_dir: str, cache_dir: str) -> str:
    if name == "g2o100k":
        from dcora_tpu.datasets import generate_large_scale_g2o

        path = os.path.join(cache_dir, "g2o100k.g2o")
        if not os.path.exists(path):
            os.makedirs(cache_dir, exist_ok=True)
            print("generating g2o100k ...", flush=True)
            generate_large_scale_g2o(path)
        return path
    return os.path.join(data_dir, name)


def measure(num_agents: int, path: str, r: int, rounds: int,
            backend: str, warmup: int = 3):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from dcora_tpu.core import lifted
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import odometry_initialization
    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.core.rtr import RTRConfig
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
    )

    ds = read_g2o_file(path)
    ms = ds.pose_pose_measurements
    d, n = ds.dim, ds.num_poses

    devices = jax.devices()
    num_devices = min(num_agents, len(devices))
    mesh = Mesh(np.array(devices[:num_devices]), ("agents",))

    odo, priv, shared, _ = partition_measurements(ms, n, num_agents)
    graphs = []
    for a in range(num_agents):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)

    t_build0 = time.time()
    pp = build_parallel_problem(graphs, backend=backend)
    pp = globalize(pp, mesh)
    build_s = time.time() - t_build0

    T = odometry_initialization([m for m in ms if m.p1 + 1 == m.p2])
    X = lifted.pad_rank(lifted.from_pose_array(T), r)
    states = []
    for a in range(num_agents):
        s, e = robot_slice(n, num_agents, a)
        states.append(RAState(rot=X.rot[s:e], sph=X.sph[:0],
                              trn=X.trn[s:e]))
    multihost = jax.process_count() > 1
    Xb = (pack_states_global(pp, states, mesh) if multihost
          else pack_states(pp, states))

    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    round_fn = make_parallel_round(pp, cfg, mesh)

    for _ in range(warmup):
        Xb, gnorms = round_fn(Xb)
    jax.block_until_ready((Xb, gnorms))
    t0 = time.time()
    for _ in range(rounds):
        Xb, gnorms = round_fn(Xb)
    jax.block_until_ready((Xb, gnorms))
    per_round = (time.time() - t0) / rounds
    return dict(
        agents=num_agents,
        devices=num_devices,
        per_round_s=per_round,
        rounds_per_s=1.0 / per_round,
        pose_updates_per_s=n / per_round,
        build_s=build_s,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="city10000.g2o",
                    help="file in --data-dir, or 'g2o100k' (synthetic)")
    ap.add_argument("--data-dir", default=os.path.join(
        os.path.dirname(__file__), os.pardir, ".data_cache"))
    ap.add_argument("--cache-dir", default=os.path.join(
        os.path.dirname(__file__), os.pardir, ".data_cache"))
    ap.add_argument("--agents", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--backend", default="tiled",
                    choices=["edge", "tiled"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.coordinator and args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    import dcora_tpu  # noqa: F401

    path = get_dataset(args.dataset, args.data_dir, args.cache_dir)
    sweep = []
    for A in args.agents:
        rec = measure(A, path, args.rank, args.rounds, args.backend)
        if sweep:
            base = sweep[0]
            rec["efficiency"] = (
                base["per_round_s"] * base["agents"]
                / (rec["per_round_s"] * rec["agents"])
            )
        else:
            rec["efficiency"] = 1.0
        sweep.append(rec)
        print(json.dumps(rec), flush=True)

    platform = jax.default_backend()
    out = dict(
        dataset=args.dataset,
        platform=platform,
        backend=args.backend,
        rank=args.rank,
        num_devices=len(jax.devices()),
        num_processes=jax.process_count(),
        # virtual CPU devices share host cores: the sweep validates the
        # sharded program, not hardware scaling
        timing_meaningful=platform != "cpu",
        sweep=sweep,
        timestamp=time.strftime("%Y-%m-%d %H:%M:%S"),
    )
    if jax.process_index() == 0:
        os.makedirs(ART, exist_ok=True)
        name = (args.dataset.replace(".g2o", "").replace("/", "_")
                + f"_{args.backend}")
        with open(os.path.join(ART, f"scaling_{name}.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k != "sweep"}))


if __name__ == "__main__":
    main()
