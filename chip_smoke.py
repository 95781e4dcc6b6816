"""Smoke test of the certified PGO / RA-SLAM main path on NVIDIA GPUs.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py              # phases (a)-(d) on one card
    python chip_smoke.py --four-gpus  # only the parallel RBCD phase, 4 cards

Phases (one process; every check that fails raises, so the script exits
non-zero and prints no result line):

  (a) device: JAX's first device must be a GPU (no CPU fallback); prints
      the card's name and power limit as nvidia-smi reports them.
  (b) SpMM: the dense-tile Hessian product (core.tiled.apply_tiled) of the
      PGO problem against the scipy Q of dcora_tpu.verification, which
      shares no code with the engine, at f32 and f64; times the f32
      product.
  (c) PGO: drivers.single_robot_pgo.run with certification on a generated
      city10000-class 3D grid; the result must certify and agree with the
      independent scipy verifier.
  (d) RA-SLAM: drivers.single_robot_raslam.run on a generated 4-robot
      range-aided set, with the same checks.
  (mesh, --four-gpus only) 4 agents of parallel RBCD on a 4-GPU mesh, each
      round compared with the same round on a 1-device mesh.

Data is generated at run time from fixed seeds into the checkout's
gitignored .data_cache/.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# PGO cell: a city10000-class 3D grid, 10,648 poses and 16,584 edges, far
# above solvers.FAST_PATH_MIN_POSES, so the f32 tile phase and the tile
# Lanczos both run.
PGO_GRID_SHAPE = (22, 22, 22)  # noise levels: datasets.ensure_grid_g2o
PGO_ETA = 1e-3  # single_robot_pgo.run's default certificate tolerance
# RA cell: 4 robots x 500 poses, each snaking over a 25 x 20 m area (2 m
# apart in height), 40 landmarks, ranges on half the pose pairs and
# landmark sightings.  Noise 0.05 rad / 0.05 m / 0.05 m: the same file
# certifies on the CPU.
RA_SET = dict(num_robots=4, poses_per_robot=500, num_landmarks=40,
              range_prob=0.5, rot_noise=0.05, trans_noise=0.05,
              range_noise=0.05, seed=3, row_length=25)
RA_ETA = 1e-4  # single_robot_raslam.run's default (the centralized demo's)

# Phase (b) tolerances, relative Frobenius error of W = X Q against the
# scipy f64 product.  f32 tiles round Q and the products to 24-bit
# mantissas (~1e-7 relative); TF32 keeps 10 bits and shows ~1e-3, so
# 1e-5 catches a precision leak.  segment_sum adds with atomics on the GPU,
# so the last bits vary from run to run; f64 stays far inside 1e-12.
SPMM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
SPMM_R_PAD = 8

# Agreement with the independent verifier, as the parity records
# (tools/parity.py, BASELINE_CAPTURED.md) hold it: the engine's and the
# scipy Q's costs agree to the 6 significant digits the table prints, the
# gradient norms to the 3 it prints, and the scipy LDL^T inertia witness
# certifies.  The gradient norm itself is reported beside the verdict: it
# bounds how far the certified point is from critical (cert_slack).
COST_RTOL = 1e-6
GRADNORM_RTOL = 1e-3

# Mesh phase: the first round on the 4-device mesh is compared with the
# same round, from the same initial state, on a 1-device mesh (where the
# separator exchange degenerates to a local copy); the next rounds run on
# the 4-device mesh alone.  The two meshes compile to different fusions
# and reduction orders (and segment_sum adds with atomics on the GPU), and
# each agent's round is one accepted trust-region step: once the steps
# shrink, a last-bit difference can flip an accept/reject decision and
# move the step by a fraction of itself (measured on 4 H100s, 22x22x22
# grid: f64 edge round 0 3.5e-14 of the step, round 1 1.3e-2; f32 tile
# round 0 6.8e-5), so later rounds are not compared.  A wrong separator
# exchange moves the first step by O(1) of itself; the limit is 1e-2.
MESH_STEP_RTOL = 1e-2
MESH_ROUNDS = 3
MESH_RANK = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


# ----------------------------------------------------------------- phases


def phase_device(count: int):
    """(a) A GPU, or exit non-zero.  Returns the devices."""
    import jax

    devs = jax.devices()
    require(devs[0].platform == "gpu",
            f"no GPU: JAX's first device is {devs[0].platform}")
    require(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    from dcora_tpu.utils.timing import gpu_name_and_power_limit

    log(f"(a) device: {len(devs)} x {devs[0].device_kind}")
    log(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    return devs[:count]


def ensure_ra_file(**overrides) -> str:
    from dcora_tpu.datasets import DATA_CACHE, generate_ra_slam_pyfg

    cfg = dict(RA_SET, **overrides)
    os.makedirs(DATA_CACHE, exist_ok=True)
    path = os.path.join(DATA_CACHE, "ra_" + "_".join(
        f"{k}{v}" for k, v in sorted(cfg.items())) + ".pyfg")
    if not os.path.exists(path):
        generate_ra_slam_pyfg(path + ".part", **cfg)
        os.replace(path + ".part", path)
    return path


def rel_fro(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def phase_spmm(g2o_path: str, reps: int = 50) -> None:
    """(b) Tile SpMM vs the scipy Q at f32 and f64; f32 timing."""
    import jax
    import jax.numpy as jnp

    from dcora_tpu import verification
    from dcora_tpu.core import tiled
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.utils.timing import device_loop_seconds

    ds = read_g2o_file(g2o_path)
    ms = ds.pose_pose_measurements
    g = LocalGraph(0, ds.dim, ds.dim)
    g.set_measurements(ms)
    P = g.problem_data()
    n, d = g.n, g.d
    Q = verification.sparse_Q_ra(ms, [], [], n, 0, 0, d)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((SPMM_R_PAD, Q.shape[0]))
    for dtype in (np.float32, np.float64):
        TP = tiled.build_tiled(P, g.dims, dtype=dtype)
        Xd = X.astype(dtype)
        ref = np.asarray((Q @ Xd.astype(np.float64).T).T)
        Xf = jnp.concatenate(
            [jnp.asarray(Xd), jnp.zeros((SPMM_R_PAD, 1), dtype)],
            axis=1)[:, TP.Q.ra_of_fl]
        apply = jax.jit(lambda V, TP=TP: tiled.apply_tiled(TP, V))
        W = np.asarray(apply(Xf))[:, np.asarray(TP.Q.fl_of_ra)]
        err = rel_fro(W.astype(np.float64), ref)
        name = np.dtype(dtype).name
        log(f"(b) SpMM {name}: rel Frobenius error {err:.3e} "
            f"(limit {SPMM_RTOL[dtype]:.0e}), tiles {TP.Q.tiles.shape[0]}"
            f" x {TP.meta.T}x{TP.meta.T}")
        require(np.isfinite(err) and err <= SPMM_RTOL[dtype],
                f"{name} tile SpMM error {err:.3e} > {SPMM_RTOL[dtype]}")
        if dtype == np.float32:
            sec = device_loop_seconds(
                lambda V, TP=TP: tiled.apply_tiled(TP, V), Xf, reps=reps)
            require(sec > 0, f"f32 SpMM timing {sec} s is not positive")
            nbytes = int(TP.Q.tiles.nbytes)
            log(f"(b) SpMM f32 time: {sec * 1e3:.4f} ms per product, "
                f"tile bytes {nbytes} -> {nbytes / sec / 1e9:.1f} GB/s "
                f"(r_pad {SPMM_R_PAD}, n {n}, "
                f"device {jax.devices()[0].device_kind})")


def check_against_verifier(label: str, measurements, res, d: int,
                           eta: float) -> None:
    """Certified, and agreeing with verification.verify_solution."""
    from dcora_tpu import verification

    require(res.certified, f"{label}: staircase did not certify")
    t0 = time.time()
    rep = verification.verify_solution(measurements, res.X, d, eta=eta)
    f_eng, f_ind = float(res.f_final), float(rep["f_indep"])
    g_eng, g_ind = float(res.gradnorm_final), float(rep["gradnorm_indep"])
    log(f"{label}: engine f={f_eng:.9g} scipy f={f_ind:.9g} "
        f"gradnorm engine={g_eng:.4e} scipy={g_ind:.4e} (eta {eta:.0e}) "
        f"LDL witness={rep['psd_proof_indep']} "
        f"min_eig~{rep['min_eig_indep']:.3e} "
        f"manifold_err={rep['manifold_err']:.1e} "
        f"(verify {time.time() - t0:.1f} s)")
    require(abs(f_eng - f_ind) <= COST_RTOL * max(1.0, abs(f_ind)),
            f"{label}: cost {f_eng} vs scipy {f_ind}")
    require(abs(g_eng - g_ind) <= GRADNORM_RTOL * g_ind,
            f"{label}: gradnorm {g_eng} vs scipy {g_ind}")
    require(rep["certified_indep"] is True,
            f"{label}: scipy LDL witness {rep['psd_proof_indep']}")


def phase_pgo(g2o_path: str) -> None:
    """(c) Certified PGO through the single-robot driver."""
    from dcora_tpu.drivers import single_robot_pgo
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.utils.timing import PhaseTimer

    timer = PhaseTimer()
    t0 = time.time()
    _, f_rounded, res = single_robot_pgo.run(
        g2o_path, certify=True, verbose=True, eta=PGO_ETA, timer=timer)
    wall = time.time() - t0
    log(f"(c) PGO: certified={res.certified} rank={res.final_rank} "
        f"f={res.f_final:.9g} f_rounded={f_rounded:.9g} "
        f"gradnorm={res.gradnorm_final:.3e} wall {wall:.1f} s")
    log("(c) PGO stages: " + timer.report().replace("\n", "; "))
    ds = read_g2o_file(g2o_path)
    check_against_verifier("(c) PGO", ds.pose_pose_measurements, res,
                           ds.dim, PGO_ETA)


def phase_ra(pyfg_path: str) -> None:
    """(d) Certified RA-SLAM through the single-robot CORA driver."""
    from dcora_tpu.drivers import single_robot_raslam
    from dcora_tpu.utils.timing import PhaseTimer

    timer = PhaseTimer()
    t0 = time.time()
    res, g, gm = single_robot_raslam.run(
        pyfg_path, min_eig_tol=RA_ETA, verbose=True, timer=timer)
    wall = time.time() - t0
    log(f"(d) RA-SLAM: n={g.n} l={g.l} b={g.b} certified={res.certified} "
        f"rank={res.final_rank} f={res.f_final:.9g} "
        f"gradnorm={res.gradnorm_final:.3e} wall {wall:.1f} s")
    log("(d) RA-SLAM stages: " + timer.report().replace("\n", "; "))
    check_against_verifier("(d) RA-SLAM", gm.relative_measurements, res,
                           g.d, RA_ETA)


def _pgo_fleet(g2o_path: str, num_agents: int):
    """Per-agent graphs and chordal-initialized states of a PGO file."""
    from dcora_tpu.core import lifted
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.core.lifted import RAState
    from dcora_tpu.drivers.multi_robot_pgo import (
        partition_measurements,
        robot_slice,
    )
    from dcora_tpu.io import read_g2o_file

    ds = read_g2o_file(g2o_path)
    ms, d, n = ds.pose_pose_measurements, ds.dim, ds.num_poses
    odo, priv, shared, _ = partition_measurements(ms, n, num_agents)
    graphs = []
    for a in range(num_agents):
        g = LocalGraph(a, MESH_RANK, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    X = lifted.pad_rank(lifted.from_pose_array(chordal_initialization(ms)),
                        MESH_RANK)
    states = []
    for a in range(num_agents):
        s, e = robot_slice(n, num_agents, a)
        states.append(RAState(rot=X.rot[s:e], sph=X.sph[:0],
                              trn=X.trn[s:e]))
    return graphs, states


def _ra_fleet(pyfg_path: str):
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.drivers.multi_robot_raslam import _slice_agent_state
    from dcora_tpu.drivers.single_robot_raslam import odometry_init_global
    from dcora_tpu.io import read_pyfg_file
    from dcora_tpu.io.remap import (
        get_global_measurements,
        get_robot_measurements,
        robot_global_indices,
    )
    from dcora_tpu.types import MAP_ID, GraphType

    ds = read_pyfg_file(pyfg_path)
    gm = get_global_measurements(ds)
    robot_meas = get_robot_measurements(ds)
    ridx = robot_global_indices(ds)
    active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
    graphs = []
    for rid in active:
        g = LocalGraph(rid, ds.dim, ds.dim, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(robot_meas[rid].relative_measurements)
        graphs.append(g)
    X0 = odometry_init_global(ds, gm)
    states = [_slice_agent_state(X0, ridx[rid]) for rid in active]
    return graphs, states, {rid: i for i, rid in enumerate(active)}


def _mesh_rounds(label: str, pp, states, devices, rounds: int) -> None:
    """`rounds` parallel RBCD rounds on the mesh over `devices`.  The first
    is compared with the same round on a 1-device mesh, relative to the
    size of its step; every round must give finite block gradnorms."""
    import jax
    from jax.sharding import Mesh

    from dcora_tpu.core.rtr import RTRConfig
    from dcora_tpu.parallel.rbcd import make_parallel_round, pack_states

    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    n = len(devices)
    round_n = make_parallel_round(pp, cfg, Mesh(np.array(devices),
                                                ("agents",)))
    X0 = jax.device_get(pack_states(pp, states))
    Xb = X0
    for k in range(rounds):
        t0 = time.time()
        Xb, gn = jax.device_get(round_n(Xb))
        log(f"(mesh) {label} round {k} on {n} devices: "
            f"{time.time() - t0:.3f} s"
            f"{' (compile included)' if k == 0 else ''}, block gradnorms "
            f"{np.array2string(np.asarray(gn), precision=3)}")
        require(np.all(np.isfinite(gn)), f"{label}: non-finite gradnorms")
        if k == 0:
            round_1 = make_parallel_round(
                pp, cfg, Mesh(np.array(devices[:1]), ("agents",)))
            X1 = jax.device_get(round_1(X0)[0])
            x0, xn, x1 = (np.concatenate([np.ravel(np.asarray(a, np.float64))
                                          for a in jax.tree.leaves(X)])
                          for X in (X0, Xb, X1))
            err = float(np.linalg.norm(xn - x1) / np.linalg.norm(x1 - x0))
            log(f"(mesh) {label} round 0: |X_{n}dev - X_1dev| / |step| = "
                f"{err:.3e} (limit {MESH_STEP_RTOL:.0e}), max abs "
                f"{np.abs(xn - x1).max():.2e}")
            require(err <= MESH_STEP_RTOL,
                    f"{label}: {n}- vs 1-device round differs by "
                    f"{err:.3e} of the step")


def phase_mesh(devices, g2o_path: str, pyfg_path: str,
               rounds: int = MESH_ROUNDS) -> None:
    """Parallel RBCD, one agent per device: `rounds` tiled f32 and edge
    f64 rounds of the PGO fleet, plus one RA fleet round (no landmarks:
    map-owned landmarks are not yet supported by parallel RBCD)."""
    from dcora_tpu.parallel.rbcd import build_parallel_problem

    graphs, states = _pgo_fleet(g2o_path, len(devices))
    # the state stays f64; the tiled block update casts to the tile dtype
    for backend, dtype in (("tiled", np.float32), ("edge", np.float64)):
        pp = build_parallel_problem(graphs, backend=backend,
                                    tile_dtype=dtype)
        _mesh_rounds(f"PGO {backend} {np.dtype(dtype).name}", pp, states,
                     devices, rounds)
    ra_graphs, ra_states, agent_of = _ra_fleet(pyfg_path)
    require(len(ra_graphs) == len(devices), "one RA robot per device")
    pp = build_parallel_problem(ra_graphs, agent_of_robot=agent_of)
    _mesh_rounds("RA edge float64", pp, ra_states, devices, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU parallel RBCD phase")
    args = ap.parse_args(argv)
    count = 4 if args.four_gpus else 1

    import jax

    devices = phase_device(count)  # before any other use of the device
    import dcora_tpu  # noqa: F401  (x64, matmul precision, compile cache)

    t_all = time.time()
    from dcora_tpu.datasets import ensure_grid_g2o

    g2o = ensure_grid_g2o(PGO_GRID_SHAPE)
    if args.four_gpus:
        phase_mesh(devices, g2o, ensure_ra_file(num_landmarks=0))
    else:
        phase_spmm(g2o)
        phase_pgo(g2o)
        phase_ra(ensure_ra_file())
    log(f"all phases passed in {time.time() - t_all:.1f} s")
    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
