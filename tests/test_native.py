"""Native (C++) runtime library: parity with the pure-Python path.

The native library covers the host-side data path (dataset loaders,
block-Jacobi preconditioner assembly) mirroring the reference's C++
parsers (DCORA_utils.cpp:179-1167) and graph assembly (Graph.cpp:1888-1960).
Every native component must agree with the Python fallback bit-for-bit up
to rounding-order differences (rtol 1e-9 on ill-conditioned info matrices).
"""

import os

import numpy as np
import pytest

import dcora_tpu.native as native
from dcora_tpu.measurements import (
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)


def _dp(name):
    """Path of a generated dataset; skip when it has no generator."""
    from dcora_tpu import datasets

    datasets.ensure_test_datasets(datasets.DATA_CACHE)
    path = os.path.join(datasets.DATA_CACHE, name)
    if not os.path.exists(path):
        pytest.skip(f"dataset {name} unavailable")
    return path


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _with_python_fallback(fn):
    """Run fn twice: native on, native off; return both results."""
    res_native = fn()
    old = os.environ.get("DCORA_NATIVE")
    os.environ["DCORA_NATIVE"] = "0"
    native._tried, native._lib = False, None
    try:
        res_py = fn()
    finally:
        if old is None:
            os.environ.pop("DCORA_NATIVE", None)
        else:
            os.environ["DCORA_NATIVE"] = old
        native._tried, native._lib = False, None
    return res_native, res_py


@pytest.mark.parametrize(
    "name",
    ["tinyGrid3D.g2o", "smallGrid3D.g2o", "CSAIL.g2o",
     "pose_graph_optimization_test_2d.g2o",
     "pose_graph_optimization_test_3d.g2o", "input_INTEL_g2o.g2o"],
)
def test_g2o_parity(name):
    from dcora_tpu.io import read_g2o_file

    nv, py = _with_python_fallback(
        lambda: read_g2o_file(_dp(name))
    )
    assert py.dim == nv.dim and py.num_poses == nv.num_poses
    assert len(py.pose_pose_measurements) == len(nv.pose_pose_measurements)
    for a, b in zip(py.pose_pose_measurements, nv.pose_pose_measurements):
        assert (a.p1, a.p2, a.fixedWeight) == (b.p1, b.p2, b.fixedWeight)
        np.testing.assert_allclose(a.R, b.R, atol=1e-13)
        np.testing.assert_allclose(a.t, b.t, atol=1e-13)
        # rtol 1e-6: tau = 2*det/trace is catastrophically ill-conditioned
        # for near-singular info matrices (input_INTEL edge 160-161 loses
        # ~9 digits), so last-ulp float-parsing differences between
        # np.loadtxt and strtod are amplified to ~1e-7
        np.testing.assert_allclose(
            [a.kappa, a.tau], [b.kappa, b.tau], rtol=1e-6
        )
    for k, T in py.ground_truth_poses.items():
        np.testing.assert_allclose(T, nv.ground_truth_poses[k], atol=1e-13)


@pytest.mark.parametrize(
    "name",
    ["pyfg_se2_test_data.pyfg", "pyfg_se3_test_data.pyfg",
     "range_aided_slam_test_2d.pyfg", "range_aided_slam_test_3d.pyfg"],
)
def test_pyfg_parity(name):
    from dcora_tpu.io import read_pyfg_file

    nv, py = _with_python_fallback(
        lambda: read_pyfg_file(_dp(name))
    )
    assert py.dim == nv.dim and py.robot_IDs == nv.robot_IDs
    for attr in (
        "robot_id_to_num_poses", "robot_id_to_num_landmarks",
        "robot_id_to_num_unit_spheres", "robot_id_to_first_pose_idx",
        "robot_id_to_first_landmark_idx",
    ):
        assert getattr(py, attr) == getattr(nv, attr), attr
    assert len(py.measurements.relative_measurements) == len(
        nv.measurements.relative_measurements
    )
    for a, b in zip(
        py.measurements.relative_measurements,
        nv.measurements.relative_measurements,
    ):
        assert type(a) is type(b)
        assert (a.r1, a.p1, a.r2, a.p2) == (b.r1, b.p1, b.r2, b.p2)
        if isinstance(a, RelativePosePoseMeasurement):
            np.testing.assert_allclose(a.R, b.R, atol=1e-13)
            np.testing.assert_allclose(
                [a.kappa, a.tau], [b.kappa, b.tau], rtol=1e-9
            )
        elif isinstance(a, RelativePoseLandmarkMeasurement):
            np.testing.assert_allclose(a.tau, b.tau, rtol=1e-9)
        elif isinstance(a, RangeMeasurement):
            assert (a.stateType1, a.stateType2, a.l) == (
                b.stateType1, b.stateType2, b.l
            )
            np.testing.assert_allclose(
                [a.range, a.precision], [b.range, b.precision], rtol=1e-12
            )
    assert len(py.measurements.pose_priors) == len(
        nv.measurements.pose_priors
    )
    for a, b in zip(
        py.measurements.pose_priors, nv.measurements.pose_priors
    ):
        np.testing.assert_allclose(a.R, b.R, atol=1e-13)
        np.testing.assert_allclose(
            [a.kappa, a.tau], [b.kappa, b.tau], rtol=1e-9
        )
    for k, u in py.ground_truth.unit_spheres.items():
        np.testing.assert_allclose(
            u, nv.ground_truth.unit_spheres[k], atol=1e-12
        )


def test_g2o_rejects_unknown_record(tmp_path):
    # the reference parser LOG(FATAL)s on unknown tokens
    # (DCORA_utils.cpp:355); both paths must reject.  FIX records are
    # *known* (skipped) since round 3 (io/g2o.py:93-96), so the fixture
    # uses a token neither parser recognizes.
    p = tmp_path / "bad.g2o"
    p.write_text("VERTEX_SE2 0 0 0 0\nEDGE_BOGUS 0 1\n")
    from dcora_tpu.io import read_g2o_file

    with pytest.raises(ValueError):
        read_g2o_file(str(p))


@pytest.mark.parametrize("case", ["pgo", "raslam"])
def test_preconditioner_parity(case):
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.io import read_g2o_file, read_pyfg_file
    from dcora_tpu.io.remap import get_global_measurements
    from dcora_tpu.solvers import make_preconditioner
    from dcora_tpu.types import GraphType

    if case == "pgo":
        ds = read_g2o_file(_dp("smallGrid3D.g2o"))
        g = LocalGraph(0, 5, ds.dim)
        g.set_measurements(ds.pose_pose_measurements)
    else:
        pf = read_pyfg_file(
            _dp("range_aided_slam_test_3d.pyfg")
        )
        g = LocalGraph(0, 4, pf.dim, GraphType.RangeAidedSLAMGraph)
        g.set_measurements(get_global_measurements(pf).relative_measurements)
    P = g.problem_data()

    Mn, Mp = _with_python_fallback(lambda: make_preconditioner(g, P))
    np.testing.assert_allclose(
        np.asarray(Mn.pose_inv), np.asarray(Mp.pose_inv),
        rtol=1e-9, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(Mn.sph_diag), np.asarray(Mp.sph_diag), rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(Mn.lmk_diag), np.asarray(Mp.lmk_diag), rtol=1e-9
    )
