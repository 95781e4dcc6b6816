"""Per-op timing of the flat RTR/tCG hot loop on a GPU.

Times each device op of the tCG inner iteration (SpMM, tangent project,
preconditioner, Weingarten apply, dots/axpys) inside a single jitted
fori_loop (so host dispatch is not counted), plus full rtr_flat outer
iterations for reference, and names the card and its power limit.  Runs
on a GPU only.

Usage: python tools/hotloop_bench.py [dataset.g2o] [rank]
       (default dataset: the generated 22x22x22 grid)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"hotloop_bench needs a GPU; JAX's first device is "
                 f"{jax.devices()[0].platform}")
    import dcora_tpu  # noqa: F401
    from dcora_tpu.core import lifted, tiled
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import odometry_initialization
    from dcora_tpu.core.rtr import RTRConfig, rtr_flat
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
    TP = tiled.build_tiled(P, g.dims, T=128, dtype=np.float32)
    meta = TP.meta
    print(f"{os.path.basename(path)} rank={rank} on "
          f"{gpu_name_and_power_limit()}")

    rng = np.random.default_rng(0)
    Xf = jnp.asarray(
        rng.standard_normal((r_pad, meta.kpad)).astype(np.float32))
    Xf = tiled.retract_flat(meta, jnp.zeros_like(Xf), Xf)
    egrad = tiled.egrad_flat(TP, Xf)
    aux = tiled.weingarten_setup(meta, Xf, egrad)

    ops = {
        "apply_tiled (SpMM)": lambda V: tiled.apply_tiled(TP, V),
        "tangent_project": lambda V: tiled.tangent_project_flat(
            meta, Xf, V) + V * 1e-6,
        "precondition": lambda V: tiled.precondition_flat(TP, V),
        "weingarten_apply": lambda V: tiled.weingarten_apply(
            meta, V, aux) + V * 1e-6,
        "hessvec-chain (SpMM+wein+tangent)": lambda V: (
            tiled.tangent_project_flat(
                meta, Xf,
                tiled.apply_tiled(TP, V)
                - tiled.weingarten_apply(meta, V, aux)) + V * 1e-6),
        "dots+axpy (x3)": lambda V: (
            V * (1.0 / (1e-8 + jnp.vdot(V, V)))
            + 0.1 * V * jnp.vdot(V, Xf) + 1e-3 * Xf * jnp.vdot(V, V)),
        "retract": lambda V: tiled.retract_flat(meta, Xf, V * 1e-3) - Xf,
    }
    for name, fn in ops.items():
        t = device_loop_seconds(fn, Xf * 1e-3)
        print(f"  {name:36s} {t * 1e6:9.1f} us")

    # full RTR outer iterations (fixed 50 tCG inners, no early stop)
    cfg = RTRConfig(gradnorm_tol=1e-300, max_outer=10, max_inner=50,
                    kappa=1e-300, theta=100.0)
    T0 = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2])
    X0 = lifted.pad_rank(lifted.from_pose_array(T0), rank)
    Xf0 = tiled.to_flat(TP, X0, r_pad=r_pad).astype(jnp.float32)
    for planar in (False, True):
        res = rtr_flat(TP, None, Xf0, cfg, planar=planar)
        jax.block_until_ready(res.X)
        t0 = time.perf_counter()
        res = rtr_flat(TP, None, Xf0, cfg, planar=planar)
        jax.block_until_ready(res.X)
        el = time.perf_counter() - t0
        print(f"  rtr_flat(planar={planar}): {int(res.outer_iters)} outer "
              f"x <=50 tCG: {el * 1e3:.1f} ms total, "
              f"{el / int(res.outer_iters) * 1e3:.2f} ms/outer, "
              f"f={float(res.f_final):.4f} g={float(res.gradnorm_final):.3e}")


if __name__ == "__main__":
    main()
