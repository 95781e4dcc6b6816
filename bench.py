"""Benchmark: lifted PGO RTR throughput on a city10000-class 3D grid.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "poses*iters/s", "device": {...},
   "gpu": "<name>, <power limit>"}

metric: poses*iterations/s of the full Riemannian trust-region step (each
outer iteration runs up to 50 preconditioned tCG inner iterations -- the
reference's hot loop, QuadraticOptimizer.cpp:234-280) on the dense-tile
f32 path at rank 5.  The graph is generated at run time
(datasets.ensure_grid_g2o, 22x22x22 poses, 16,584 edges) into the
checkout's .data_cache/.  The timed run follows one untimed run that
compiles.  Runs on a GPU only: on any other platform it exits non-zero
without a number.
"""

import json
import os
import sys
import time

RANK = 5
OUTER_ITERS = 20
TCG_ITERS = 50


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX's first device is "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1

    import dcora_tpu  # noqa: F401
    from dcora_tpu.core import lifted, tiled
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import odometry_initialization
    from dcora_tpu.core.rtr import RTRConfig, rtr_flat
    from dcora_tpu.datasets import ensure_grid_g2o
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.utils.timing import gpu_name_and_power_limit

    path = ensure_grid_g2o()
    ds = read_g2o_file(path)
    n, d = ds.num_poses, ds.dim
    g = LocalGraph(0, RANK, d)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data()
    TP = tiled.build_tiled(P, g.dims, T=128, dtype=np.float32)
    cfg = RTRConfig(gradnorm_tol=1e-300, max_outer=OUTER_ITERS,
                    max_inner=TCG_ITERS)

    T = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2]
    )
    X0 = lifted.pad_rank(lifted.from_pose_array(T), RANK)
    Xf0 = tiled.to_flat(TP, X0, r_pad=8).astype(jnp.float32)

    res = rtr_flat(TP, None, Xf0, cfg)  # compile + warmup
    jax.block_until_ready(res.X)

    t0 = time.perf_counter()
    res = rtr_flat(TP, None, Xf0, cfg)
    jax.block_until_ready(res.X)
    elapsed = time.perf_counter() - t0
    iters = int(res.outer_iters)
    d0 = jax.devices()[0]
    print(json.dumps({
        "metric": (
            f"lifted-PGO RTR poses*iters/s on {os.path.basename(path)} "
            f"(rank {RANK}, {TCG_ITERS} tCG/iter, f32 tiles)"
        ),
        "value": n * iters / elapsed,
        "unit": "poses*iters/s",
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu_name_and_power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
