"""Microbenchmark of the Hessian SpMM W = X Q on a GPU.

Times the dense-tile path (core.tiled.apply_tiled: gather -> batched dot
-> segment_sum) at f32 and f64, and the residual-form edge path
(problem.apply_Q) at f64, each inside one jitted fori_loop.  For the tile
path it reports the streamed tile bytes over the measured time, beside
what a plain device copy of the same size reaches in the same process, and
the card's name and power limit.  Runs on a GPU only.

Usage: python tools/spmm_bench.py [dataset.g2o] [rank]
       (default dataset: the generated 22x22x22 grid)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"spmm_bench needs a GPU; JAX's first device is "
                 f"{jax.devices()[0].platform}")
    import dcora_tpu  # noqa: F401
    from dcora_tpu.core import lifted, problem as prob, tiled
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.datasets import ensure_grid_g2o
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.utils.timing import (
        device_loop_seconds,
        gpu_name_and_power_limit,
    )

    path = sys.argv[1] if len(sys.argv) > 1 else ensure_grid_g2o()
    rank = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    r_pad = max(8, -(-rank // 8) * 8)

    ds = read_g2o_file(path)
    g = LocalGraph(0, rank, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data()
    print(f"{os.path.basename(path)}: n={g.dims.n} rank={rank} "
          f"r_pad={r_pad} on {gpu_name_and_power_limit()}")
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        TP = tiled.build_tiled(P, g.dims, T=128, dtype=dtype)
        Xf = jnp.asarray(
            rng.standard_normal((r_pad, TP.meta.kpad)).astype(dtype))
        sec = device_loop_seconds(lambda X, TP=TP: tiled.apply_tiled(TP, X),
                                  Xf)
        nbytes = int(TP.Q.tiles.nbytes)
        buf = jnp.zeros(nbytes // np.dtype(dtype).itemsize, dtype)
        copy_sec = device_loop_seconds(lambda B: B + 1, buf)
        # a copy reads and writes every byte once
        print(f"tiles {np.dtype(dtype).name}: {TP.Q.tiles.shape[0]} tiles, "
              f"{nbytes / 1e6:.1f} MB: {sec * 1e3:.4f} ms -> "
              f"{nbytes / sec / 1e9:.1f} GB/s; copy of the same size "
              f"{2 * nbytes / copy_sec / 1e9:.1f} GB/s")
    X = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape)),
                     lifted.zeros(g.dims, rank))
    sec = device_loop_seconds(lambda V: prob.apply_Q(P, V), X)
    print(f"edge path float64: {sec * 1e3:.4f} ms per product")


if __name__ == "__main__":
    main()
