"""Tiled block-sparse path vs. the RAState edge path (oracle tests).

The flat layout (tiled.py) must reproduce the edge-path cost engine
(problem.py) exactly when built at f64: same Q operator, same tangent
projections, same preconditioner, same RTR result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dcora_tpu.core import lifted, manifold, tiled
from dcora_tpu.core import problem as prob
from dcora_tpu.core.graph import LocalGraph
from dcora_tpu.core.rtr import (
    FLAT_BACKEND,
    RTRConfig,
    riemannian_gradient,
    rtr,
    rtr_flat,
)
from dcora_tpu.io import read_g2o_file, read_pyfg_file
from dcora_tpu.measurements import (
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)
from dcora_tpu.types import ProblemDims, StateType


def _random_measurements(rng, n, l, b, d):  # noqa: E741
    """Random weighted measurements of every type present (l ranges,
    b landmarks), all local to robot 0."""
    ms = []
    for i in range(n - 1):
        R = np.asarray(
            manifold.rotation_project(jnp.asarray(rng.standard_normal((d, d))))
        )
        ms.append(RelativePosePoseMeasurement(
            0, i, 0, i + 1, R, rng.standard_normal(d),
            kappa=rng.uniform(1, 5), tau=rng.uniform(1, 5),
            weight=rng.uniform(0.3, 1.0)))
    for j in range(b):
        i = int(rng.integers(n))
        ms.append(RelativePoseLandmarkMeasurement(
            0, i, 0, j, rng.standard_normal(d), tau=rng.uniform(1, 5),
            weight=rng.uniform(0.3, 1.0)))
    for q in range(l):
        i = int(rng.integers(n))
        j = int(rng.integers(b)) if b else int(rng.integers(n))
        st2 = StateType.Landmark if b else StateType.Pose
        ms.append(RangeMeasurement(
            0, i, 0, j, StateType.Pose, st2, q,
            float(rng.uniform(0.5, 3.0)),
            precision=rng.uniform(1, 5), weight=rng.uniform(0.3, 1.0)))
    return ms


def _random_ra_graph(rng, n=7, l=4, b=3, d=3):  # noqa: E741
    """A local graph with all measurement types, weights, and a prior."""
    ms = _random_measurements(rng, n, l, b, d)
    g = LocalGraph(0, d, d)
    g.set_measurements(ms)
    P0 = np.zeros((d, d + 1))
    P0[:, :d] = np.eye(d)
    g.set_prior(0, P0)
    return g


@pytest.mark.parametrize("T", [16, 128])
def test_apply_tiled_matches_edge_path_ra(T):
    rng = np.random.default_rng(0)
    g = _random_ra_graph(rng)
    P = g.problem_data()
    TP = tiled.build_tiled(P, g.dims, T=T, dtype=np.float64)
    X = manifold.random_state(jax.random.PRNGKey(1), g.dims, g.d)

    W_ref = prob.apply_Q(P, X, prefer_ell=False)
    Xf = tiled.to_flat(TP, X)
    Wf = tiled.apply_tiled(TP, Xf)
    W = tiled.from_flat(TP, Wf)

    np.testing.assert_allclose(np.asarray(W.rot), np.asarray(W_ref.rot),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(W.sph), np.asarray(W_ref.sph),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(W.trn), np.asarray(W_ref.trn),
                               atol=1e-10)

    # cost agreement
    f_ref = float(prob.cost(P, X))
    f_fl = float(tiled.cost_flat(TP, Xf))
    np.testing.assert_allclose(f_fl, f_ref, rtol=1e-12)


def test_planar_ops_match_flat_ops():
    """Planar-layout manifold/preconditioner ops == flat-layout ops.

    Exercised on a graph with every variable kind (poses, spheres,
    landmarks).  retract_planar uses Newton-Schulz instead of eigh, so it
    is checked both against retract_flat and for manifold feasibility,
    including a large step (NS scaling covers per-pose step norms ~1e3).
    """
    rng = np.random.default_rng(5)
    g = _random_ra_graph(rng, n=9, l=5, b=4)
    P = g.problem_data()
    TP = tiled.build_tiled(P, g.dims, T=128, dtype=np.float64)
    meta = TP.meta
    X = manifold.random_state(jax.random.PRNGKey(2), g.dims, g.d)
    Xf = tiled.to_flat(TP, X)
    Xp = tiled.to_planar(meta, Xf)

    np.testing.assert_allclose(np.asarray(tiled.from_planar(meta, Xp)),
                               np.asarray(Xf), atol=0)

    Vf = jnp.asarray(rng.standard_normal(Xf.shape))
    Vp = tiled.to_planar(meta, Vf)

    out_flat = tiled.tangent_project_flat(meta, Xf, Vf)
    out_pl = tiled.from_planar(
        meta, tiled.tangent_project_planar(meta, Xp, Vp))
    np.testing.assert_allclose(np.asarray(out_pl), np.asarray(out_flat),
                               atol=1e-12)

    out_flat = tiled.precondition_flat(TP, Vf)
    out_pl = tiled.from_planar(meta, tiled.precondition_planar(TP, Vp))
    np.testing.assert_allclose(np.asarray(out_pl), np.asarray(out_flat),
                               atol=1e-12)

    egf = tiled.egrad_flat(TP, Xf)
    aux_f = tiled.weingarten_setup(meta, Xf, egf)
    aux_p = tiled.weingarten_setup_planar(meta, Xp,
                                          tiled.to_planar(meta, egf))
    out_flat = tiled.weingarten_apply(meta, Vf, aux_f)
    out_pl = tiled.from_planar(
        meta, tiled.weingarten_apply_planar(meta, Vp, aux_p))
    np.testing.assert_allclose(np.asarray(out_pl), np.asarray(out_flat),
                               atol=1e-12)

    for scale in (1e-3, 1.0, 300.0):
        Tf = tiled.tangent_project_flat(meta, Xf, Vf * scale)
        Tp = tiled.to_planar(meta, Tf)
        R_flat = tiled.retract_flat(meta, Xf, Tf)
        R_pl = tiled.from_planar(meta, tiled.retract_planar(meta, Xp, Tp))
        np.testing.assert_allclose(np.asarray(R_pl), np.asarray(R_flat),
                                   atol=1e-9)
        err = manifold.manifold_error(tiled.from_flat(TP, R_pl))
        assert float(err) < 1e-10


def test_flat_roundtrip_and_rank_padding():
    rng = np.random.default_rng(1)
    g = _random_ra_graph(rng)
    P = g.problem_data()
    TP = tiled.build_tiled(P, g.dims, T=32, dtype=np.float64)
    X = manifold.random_state(jax.random.PRNGKey(2), g.dims, g.d)
    Xf = tiled.to_flat(TP, X, r_pad=8)
    assert Xf.shape[0] == 8
    # rows above rank stay zero, pad columns stay zero
    assert float(jnp.abs(Xf[g.d:]).max()) == 0.0
    X2 = tiled.from_flat(TP, Xf, r=g.d)
    np.testing.assert_allclose(np.asarray(X2.rot), np.asarray(X.rot),
                               atol=0)
    np.testing.assert_allclose(np.asarray(X2.trn), np.asarray(X.trn),
                               atol=0)


def test_tangent_precond_retract_match_rastate():
    rng = np.random.default_rng(2)
    g = _random_ra_graph(rng)
    P = g.problem_data()
    TP = tiled.build_tiled(P, g.dims, T=32, dtype=np.float64)
    key = jax.random.PRNGKey(3)
    X = manifold.random_state(key, g.dims, g.d)
    V = manifold.random_state(jax.random.split(key)[0], g.dims, g.d)
    Xf = tiled.to_flat(TP, X)
    Vf = tiled.to_flat(TP, V)

    # tangent projection
    T_ref = manifold.tangent_project(X, V)
    T_fl = tiled.from_flat(TP, tiled.tangent_project_flat(TP.meta, Xf, Vf))
    for a, b in zip(jax.tree.leaves(T_fl), jax.tree.leaves(T_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)

    # preconditioner (reference reg 0.1 used in both builds)
    M = prob.build_preconditioner(P, g.n, g.l, g.b, g.d, 0.1)
    P_ref = prob.apply_preconditioner(M, V)
    P_fl = tiled.from_flat(TP, tiled.precondition_flat(TP, Vf))
    for a, b in zip(jax.tree.leaves(P_fl), jax.tree.leaves(P_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)

    # retraction (along a genuine tangent step so the polar factor exists)
    Vt = manifold.tangent_project(X, V).scale(0.1)
    Vtf = tiled.to_flat(TP, Vt)
    R_ref = manifold.retract(X, Vt)
    R_fl = tiled.from_flat(TP, tiled.retract_flat(TP.meta, Xf, Vtf))
    for a, b in zip(jax.tree.leaves(R_fl), jax.tree.leaves(R_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-10)
    # manifold feasibility preserved
    assert float(manifold.manifold_error(R_fl)) < 1e-12


def test_rtr_flat_matches_rastate_rtr_tinygrid(data_dir):
    """Full RTR on tinyGrid3D: flat f64 path lands on the same optimum."""
    ds = read_g2o_file(f"{data_dir}/tinyGrid3D.g2o")
    r, d = 5, ds.dim
    g = LocalGraph(0, r, d)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data()
    from dcora_tpu.solvers import make_preconditioner

    M = make_preconditioner(g, P)
    G = lifted.zeros(g.dims, r)
    from dcora_tpu.core.init import odometry_initialization

    T = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2]
    )
    X0 = lifted.pad_rank(lifted.from_pose_array(T), r)
    cfg = RTRConfig(gradnorm_tol=1e-6, max_outer=50, max_inner=50)

    res_ref = rtr(P, G, M, X0, cfg)

    TP = tiled.build_tiled(P, g.dims, T=64, dtype=np.float64)
    Xf0 = tiled.to_flat(TP, X0, r_pad=8)
    Gf = tiled.to_flat(TP, G, r_pad=8)
    res_fl = rtr_flat(TP, Gf, Xf0, cfg)

    np.testing.assert_allclose(float(res_fl.f_final),
                               float(res_ref.f_final), rtol=1e-8)
    assert float(res_fl.gradnorm_final) < 1e-6
    X_out = tiled.from_flat(TP, res_fl.X, r=r)
    assert float(manifold.manifold_error(X_out)) < 1e-9
    # the f64 gradient of the edge path agrees the flat solution is critical
    gn = float(riemannian_gradient(P, X_out, G).norm())
    assert gn < 1e-5


def test_rtr_flat_f32_coarse_phase(data_dir):
    """f32 tiles drive the cost near the optimum (coarse-phase setting),
    then an f64 edge-path refine finishes to reference tolerance."""
    ds = read_g2o_file(f"{data_dir}/tinyGrid3D.g2o")
    r, d = 5, ds.dim
    g = LocalGraph(0, r, d)
    g.set_measurements(ds.pose_pose_measurements)
    P = g.problem_data()
    from dcora_tpu.core.init import odometry_initialization
    from dcora_tpu.solvers import make_preconditioner

    T = odometry_initialization(
        [m for m in ds.pose_pose_measurements if m.p1 + 1 == m.p2]
    )
    X0 = lifted.pad_rank(lifted.from_pose_array(T), r)
    G = lifted.zeros(g.dims, r)
    TP = tiled.build_tiled(P, g.dims, T=64, dtype=np.float32)
    Xf0 = tiled.to_flat(TP, X0, r_pad=8).astype(jnp.float32)
    cfg = RTRConfig(gradnorm_tol=1e-3, max_outer=100, max_inner=50)
    res32 = rtr_flat(TP, None, Xf0, cfg)

    X_warm = manifold.project(
        jax.tree.map(lambda a: a.astype(jnp.float64),
                     tiled.from_flat(TP, res32.X, r=r))
    )
    M = make_preconditioner(g, P)
    res = rtr(P, G, M, X_warm, RTRConfig(gradnorm_tol=1e-8, max_outer=30,
                                         max_inner=100))
    assert float(res.gradnorm_final) < 1e-8


def test_tile_precondition_matches_scipy_blockdiag():
    """diag_inv tile solve == numpy block-diagonal solve of the same
    regularized diagonal tiles of the scalar flat Q."""
    rng = np.random.default_rng(11)
    g = _random_ra_graph(rng, n=9, l=5, b=4)
    P = g.problem_data()
    reg = 0.37
    T = 32
    TP = tiled.build_tiled(P, g.dims, T=T, dtype=np.float64, reg=reg,
                           tile_precond=True)
    assert TP.diag_inv is not None
    meta = TP.meta
    # scipy oracle: assemble the flat Q from the tile list, take the
    # regularized diagonal tiles, block-solve
    k, kpad, nt = meta.k, meta.kpad, meta.nt
    dense = np.asarray(TP.Q.tiles)
    tr = np.asarray(TP.Q.tile_rows)
    tc = np.asarray(TP.Q.tile_cols)
    rng = np.random.default_rng(3)
    V = rng.standard_normal((8, kpad))
    out = np.zeros_like(V)
    for c in range(nt):
        sel = (tr == c) & (tc == c)
        B = dense[sel].sum(axis=0) + reg * np.eye(T)
        out[:, c * T:(c + 1) * T] = np.linalg.solve(
            B.T, V[:, c * T:(c + 1) * T].T
        ).T
    W = np.asarray(tiled.precondition_flat(TP, jnp.asarray(V)))
    np.testing.assert_allclose(W, out, rtol=1e-10, atol=1e-12)


def test_apply_tiled_chunked_matches_unchunked(data_dir, monkeypatch):
    """The scan-chunked tile axis (g2o100k-scale OOM fix) must reproduce
    the single-dot path bit-for-bit up to summation order."""
    import os

    import jax.numpy as jnp

    from dcora_tpu.core import tiled
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.io import read_g2o_file

    ds = read_g2o_file(os.path.join(data_dir, "smallGrid3D.g2o"))
    g = LocalGraph(0, 5, ds.dim)
    g.set_measurements(ds.pose_pose_measurements)
    TP = tiled.build_tiled(g.problem_data(), g.dims, T=32,
                           dtype=np.float64)
    rng = np.random.default_rng(0)
    Xf = jnp.asarray(rng.standard_normal((8, TP.meta.kpad)))
    ref = tiled.apply_tiled(TP, Xf)
    monkeypatch.setenv("DCORA_TILE_CHUNK", "4")
    out = tiled.apply_tiled(TP, Xf)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["pgo", "ra"])
@pytest.mark.parametrize("d", [2, 3])
def test_apply_tiled_matches_scipy_Q(d, kind, dtype, chunked, monkeypatch):
    """W = X Q of the tiles against verification.sparse_Q_ra, the scipy
    incidence-matrix Q that shares no code with the engine.  Tolerances
    are relative Frobenius errors: f32 tiles keep ~7 digits, f64 ~16.
    chunked=True forces the scan over tile chunks (m > _tile_chunk())."""
    from dcora_tpu import verification

    if chunked:
        monkeypatch.setenv("DCORA_TILE_CHUNK", "4")
    n, l, b = (30, 0, 0) if kind == "pgo" else (30, 6, 4)  # noqa: E741
    ms = _random_measurements(np.random.default_rng(d), n, l, b, d)
    g = LocalGraph(0, d, d)
    g.set_measurements(ms)
    TP = tiled.build_tiled(g.problem_data(), g.dims, T=16, dtype=dtype)
    m = int(TP.Q.tiles.shape[0])
    assert (m > tiled._tile_chunk()) == chunked
    pp, pl, rg = verification.split_measurements(ms)
    Q = verification.sparse_Q_ra(pp, pl, rg, n, l, b, d)
    X = np.random.default_rng(7).standard_normal((8, Q.shape[0]))
    X = X.astype(dtype)
    ref = (Q @ X.astype(np.float64).T).T
    Xf = jnp.concatenate([jnp.asarray(X), jnp.zeros((8, 1), dtype)],
                         axis=1)[:, TP.Q.ra_of_fl]
    W = np.asarray(tiled.apply_tiled(TP, Xf))[:, np.asarray(TP.Q.fl_of_ra)]
    assert W.dtype == dtype
    err = np.linalg.norm(W - ref) / np.linalg.norm(ref)
    assert err < (1e-5 if dtype == np.float32 else 1e-12), err


def test_build_tiled_has_no_kernel_layouts():
    """One Q representation per precision: the tile list and the two
    ordering maps, with no kernel-specific packing or switch."""
    import inspect

    assert tiled.TiledQ._fields == (
        "tiles", "tile_rows", "tile_cols", "ra_of_fl", "fl_of_ra")
    assert "with_pallas" not in inspect.signature(
        tiled.build_tiled).parameters
