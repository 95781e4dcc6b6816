"""Sharded synchronous-parallel RBCD tests on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
    make_parallel_round,
    pack_states,
    unpack_states,
)


NUM_AGENTS = 4


@pytest.fixture(scope="module")
def parallel_setup(data_dir):
    ds = read_g2o_file(f"{data_dir}/smallGrid3D.g2o")
    ms = ds.pose_pose_measurements
    d, n, r = ds.dim, ds.num_poses, 5
    odo, priv, shared, _ = partition_measurements(ms, n, NUM_AGENTS)
    graphs = []
    for a in range(NUM_AGENTS):
        g = LocalGraph(a, r, d)
        g.set_measurements(odo[a] + priv[a] + shared[a])
        graphs.append(g)
    T = chordal_initialization(ms)
    X = lifted.pad_rank(lifted.from_pose_array(T), r)
    states = []
    for a in range(NUM_AGENTS):
        s, e = robot_slice(n, NUM_AGENTS, a)
        states.append(
            RAState(rot=X.rot[s:e], sph=X.sph[:0], trn=X.trn[s:e])
        )
    central = LocalGraph(0, r, d)
    central.set_measurements(ms)
    return ds, graphs, states, central, X


def _global_state(pp, states, central, r):
    """Reassemble the global state from per-agent blocks."""
    rots = [s.rot for s in states]
    trns = [s.trn for s in states]
    return RAState(
        rot=jnp.concatenate(rots),
        sph=jnp.zeros((0, r)),
        trn=jnp.concatenate(trns),
    )


def test_parallel_rbcd_decreases_cost(parallel_setup):
    ds, graphs, states, central, X0 = parallel_setup
    r = 5
    pp = build_parallel_problem(graphs)
    devices = np.array(jax.devices()[:NUM_AGENTS])
    mesh = Mesh(devices, ("agents",))
    cfg = RTRConfig(
        gradnorm_tol=1e-2, max_inner=50, initial_radius=100.0,
        single_accepted_step=True,
    )
    round_fn = make_parallel_round(pp, cfg, mesh)

    P = central.problem_data()
    G0 = lifted.zeros(central.dims, r)
    Xb = pack_states(pp, states)

    costs = []
    for it in range(30):
        Xglob = _global_state(pp, unpack_states(pp, Xb), central, r)
        costs.append(float(prob.cost(P, Xglob)))
        Xb, gnorms = round_fn(Xb)
    Xglob = _global_state(pp, unpack_states(pp, Xb), central, r)
    costs.append(float(prob.cost(P, Xglob)))
    gradnorm = float(riemannian_gradient(P, Xglob, G0).norm())

    assert costs[-1] < costs[0] - 1e-6, costs[:3] + costs[-3:]
    # monotone-ish decrease overall and approaching a critical point
    assert costs[-1] <= min(costs[:5])
    assert gradnorm < 10.0, gradnorm


def test_parallel_matches_sequential_fixed_point(parallel_setup):
    """If the global state is a critical point, a parallel round must not
    move it (consistency between parallel and agent-based formulations)."""
    ds, graphs, states, central, X0 = parallel_setup
    r = 5
    # first drive the centralized problem to a critical point
    from dcora_tpu.core.rtr import rtr
    from dcora_tpu.solvers import make_preconditioner

    P = central.problem_data()
    M = make_preconditioner(central, P)
    cfg = RTRConfig(gradnorm_tol=1e-8, max_outer=100, max_inner=200)
    G0 = lifted.zeros(central.dims, r)
    Xopt = rtr(P, G0, M, X0, cfg).X
    gnorm0 = float(riemannian_gradient(P, Xopt, G0).norm())
    assert gnorm0 < 1e-6

    pp = build_parallel_problem(graphs)
    devices = np.array(jax.devices()[:NUM_AGENTS])
    mesh = Mesh(devices, ("agents",))
    cfg1 = RTRConfig(
        gradnorm_tol=1e-2, max_inner=50, single_accepted_step=True
    )
    round_fn = make_parallel_round(pp, cfg1, mesh)

    n = central.n
    blocks = []
    for a in range(NUM_AGENTS):
        s, e = robot_slice(n, NUM_AGENTS, a)
        blocks.append(
            RAState(rot=Xopt.rot[s:e], sph=Xopt.sph[:0],
                    trn=Xopt.trn[s:e])
        )
    Xb = pack_states(pp, blocks)
    Xb2, gnorms = round_fn(Xb)
    # block gradients are ~zero so the one-accepted-step solver should not
    # move (it skips when gradnorm < tol)
    Xglob2 = _global_state(pp, unpack_states(pp, Xb2), central, r)
    delta = float((Xglob2 - Xopt).norm())
    assert delta < 1e-6, delta


def test_parallel_pgo_driver_smoke(data_dir):
    """The user-facing scaling-mode driver converges on the CPU mesh."""
    from dcora_tpu.drivers.parallel_pgo import run

    Xg, cost, gradnorm = run(
        4, f"{data_dir}/smallGrid3D.g2o", max_rounds=80,
        rgrad_norm_tol=0.5, check_every=5,
    )
    assert gradnorm < 0.5
    assert np.isfinite(cost)


@pytest.fixture(scope="module")
def parallel_ra_setup(data_dir):
    """Per-robot RA blocks (spheres + landmarks) from the 2-robot PyFG
    test set — exercises the unit-sphere/landmark machinery of
    parallel/rbcd.py (fix_sph_src, pub_sph_idx, range remaps)."""
    from dcora_tpu.drivers.multi_robot_raslam import _slice_agent_state
    from dcora_tpu.drivers.single_robot_raslam import odometry_init_global
    from dcora_tpu.io import read_pyfg_file
    from dcora_tpu.io.remap import (
        get_global_measurements,
        get_robot_measurements,
        robot_global_indices,
    )
    from dcora_tpu.types import GraphType, MAP_ID

    ds = read_pyfg_file(f"{data_dir}/range_aided_slam_test_3d.pyfg")
    gm = get_global_measurements(ds)
    robot_meas = get_robot_measurements(ds)
    ridx = robot_global_indices(ds)
    d = ds.dim
    r = d
    active = [rid for rid in sorted(ds.robot_IDs) if rid != MAP_ID]
    graphs = []
    for rid in active:
        g = LocalGraph(rid, r, d, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(robot_meas[rid].relative_measurements)
        graphs.append(g)
    X0 = odometry_init_global(ds, gm)
    states = [_slice_agent_state(X0, ridx[rid]) for rid in active]
    central = LocalGraph(0, r, d, GraphType.RangeAidedSLAMGraph)
    central.set_measurements(gm.relative_measurements)
    gt = gm.ground_truth_init
    return ds, active, ridx, graphs, states, central, gt


def _global_ra_state(pp, states, active, ridx, n, l, b, r):  # noqa: E741
    from dcora_tpu.drivers.multi_robot_raslam import _scatter_agent_state

    rot = np.zeros((n, r, pp.d))
    sph = np.zeros((l, r))
    trn = np.zeros((n + b, r))
    for a, rid in enumerate(active):
        _scatter_agent_state((rot, sph, trn), states[a], ridx[rid], n)
    return RAState(rot=jnp.asarray(rot), sph=jnp.asarray(sph),
                   trn=jnp.asarray(trn))


def test_parallel_ra_round_decreases_cost(parallel_ra_setup):
    """The RA path of the parallel scaling mode (spheres + landmarks in
    the separator exchange) decreases the global RA cost."""
    ds, active, ridx, graphs, states, central, gt = parallel_ra_setup
    r = ds.dim
    agent_of_robot = {rid: i for i, rid in enumerate(active)}
    pp = build_parallel_problem(graphs, agent_of_robot=agent_of_robot)
    # the sphere/landmark separator machinery must actually be exercised
    assert pp.l_max > 0, "test set has no unit spheres?"
    assert int(np.asarray(pp.batched.fix_sph_src).size) > 0
    devices = np.array(jax.devices()[: len(active)])
    mesh = Mesh(devices, ("agents",))
    cfg = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                    single_accepted_step=True)
    round_fn = make_parallel_round(pp, cfg, mesh)

    P = central.problem_data()
    n, l, b = gt.n, gt.l, gt.b  # noqa: E741
    Xb = pack_states(pp, states)
    costs = []
    for _ in range(25):
        Xg = _global_ra_state(pp, unpack_states(pp, Xb), active, ridx,
                              n, l, b, r)
        costs.append(float(prob.cost(P, Xg)))
        Xb, gnorms = round_fn(Xb)
    Xg = _global_ra_state(pp, unpack_states(pp, Xb), active, ridx,
                          n, l, b, r)
    costs.append(float(prob.cost(P, Xg)))
    assert costs[-1] < costs[0] * 0.2, costs[:3] + costs[-3:]
    assert costs[-1] <= min(costs[:5])


def test_parallel_ra_fixed_point(parallel_ra_setup):
    """A critical point of the global RA problem must not move under one
    parallel RA round (consistency of the sphere/landmark separator
    protocol with the central formulation)."""
    from dcora_tpu.core.rtr import rtr
    from dcora_tpu.drivers.multi_robot_raslam import _slice_agent_state
    from dcora_tpu.solvers import make_preconditioner

    ds, active, ridx, graphs, states, central, gt = parallel_ra_setup
    r = ds.dim
    P = central.problem_data()
    M = make_preconditioner(central, P)
    cfg = RTRConfig(gradnorm_tol=1e-9, max_outer=200, max_inner=200)
    G0 = lifted.zeros(central.dims, r)
    Xopt = rtr(P, G0, M, gt, cfg).X  # noiseless: GT is near the optimum
    gnorm0 = float(riemannian_gradient(P, Xopt, G0).norm())
    assert gnorm0 < 1e-6, gnorm0

    agent_of_robot = {rid: i for i, rid in enumerate(active)}
    pp = build_parallel_problem(graphs, agent_of_robot=agent_of_robot)
    devices = np.array(jax.devices()[: len(active)])
    mesh = Mesh(devices, ("agents",))
    cfg1 = RTRConfig(gradnorm_tol=1e-2, max_inner=50,
                     single_accepted_step=True)
    round_fn = make_parallel_round(pp, cfg1, mesh)

    blocks = [_slice_agent_state(Xopt, ridx[rid]) for rid in active]
    Xb = pack_states(pp, blocks)
    Xb2, gnorms = round_fn(Xb)
    n, l, b = gt.n, gt.l, gt.b  # noqa: E741
    Xg2 = _global_ra_state(pp, unpack_states(pp, Xb2), active, ridx,
                           n, l, b, r)
    delta = float((Xg2 - Xopt).norm())
    assert delta < 1e-6, delta


def test_parallel_raslam_driver_smoke(data_dir):
    """The user-facing parallel RA scaling driver converges on the mesh."""
    from dcora_tpu.drivers.parallel_raslam import run

    Xg, cost, gradnorm = run(
        f"{data_dir}/range_aided_slam_test_3d.pyfg", max_rounds=100,
        rgrad_norm_tol=0.2, check_every=10,
    )
    assert gradnorm < 0.2
    assert np.isfinite(cost)


def test_parallel_rbcd_tiled_backend(parallel_setup):
    """backend="tiled" (dense-tile SpMM block updates): decreases cost like the
    edge path and does not move a critical point (f64 tiles => exact)."""
    ds, graphs, states, central, X0 = parallel_setup
    r = 5
    pp = build_parallel_problem(graphs, backend="tiled",
                                tile_dtype=np.float64)
    assert pp.tiled is not None
    devices = np.array(jax.devices()[:NUM_AGENTS])
    mesh = Mesh(devices, ("agents",))
    cfg = RTRConfig(
        gradnorm_tol=1e-2, max_inner=50, initial_radius=100.0,
        single_accepted_step=True,
    )
    round_fn = make_parallel_round(pp, cfg, mesh)

    P = central.problem_data()
    Xb = pack_states(pp, states)
    costs = []
    for it in range(15):
        Xglob = _global_state(pp, unpack_states(pp, Xb), central, r)
        costs.append(float(prob.cost(P, Xglob)))
        Xb, gnorms = round_fn(Xb)
    Xglob = _global_state(pp, unpack_states(pp, Xb), central, r)
    costs.append(float(prob.cost(P, Xglob)))
    assert costs[-1] < costs[0] - 1e-6, costs[:3] + costs[-3:]
    assert costs[-1] <= min(costs[:5])

    # fixed-point consistency: drive the central problem to a critical
    # point, scatter it into blocks, one tiled round must not move it
    from dcora_tpu.core.rtr import rtr
    from dcora_tpu.solvers import make_preconditioner

    M = make_preconditioner(central, P)
    cfg2 = RTRConfig(gradnorm_tol=1e-8, max_outer=100, max_inner=200)
    G0 = lifted.zeros(central.dims, r)
    Xopt = rtr(P, G0, M, X0, cfg2).X
    n = central.n
    blocks = []
    for a in range(NUM_AGENTS):
        s, e = robot_slice(n, NUM_AGENTS, a)
        blocks.append(RAState(rot=Xopt.rot[s:e], sph=Xopt.sph[:0],
                              trn=Xopt.trn[s:e]))
    Xb = pack_states(pp, blocks)
    Xb2, gnorms = round_fn(Xb)
    Xglob2 = _global_state(pp, unpack_states(pp, Xb2), central, r)
    delta = float((Xglob2 - Xopt).norm())
    assert delta < 1e-6, delta
