"""ctypes bindings for the native runtime library (native/).

The native library covers the host-side data path — dataset loaders and
block-Jacobi preconditioner assembly — mirroring the parts the reference
implements in C++ (parsers: DCORA_utils.cpp:179-1167; graph assembly:
Graph.cpp:1888-1960).  The library is built from native/src into
native/build (not tracked) at first use.  Everything degrades gracefully:
if it cannot be built (no compiler), callers fall back to the pure
Python/numpy implementations.

Set ``DCORA_NATIVE=0`` to disable the native path entirely.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libdcora_native.so")

_lib = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build_library() -> bool:
    """Build the library unless present; True when it exists afterwards.

    Runs under an exclusive lock on native/build/.lock, so processes that
    start together (test workers) neither race on the outputs nor load a
    half-linked file."""
    build_dir = os.path.dirname(_LIB_PATH)
    try:
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(_LIB_PATH):
                subprocess.run(
                    ["make", "-s", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            return os.path.exists(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False


def _declare(lib) -> None:
    lib.dcora_g2o_parse.restype = ct.c_void_p
    lib.dcora_g2o_parse.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.dcora_g2o_dim.restype = ct.c_int
    lib.dcora_g2o_dim.argtypes = [ct.c_void_p]
    lib.dcora_g2o_num_vertices.restype = ct.c_int64
    lib.dcora_g2o_num_vertices.argtypes = [ct.c_void_p]
    lib.dcora_g2o_num_edges.restype = ct.c_int64
    lib.dcora_g2o_num_edges.argtypes = [ct.c_void_p]
    lib.dcora_g2o_get_vertices.restype = None
    lib.dcora_g2o_get_vertices.argtypes = [ct.c_void_p, _i64p, _f64p, _f64p]
    lib.dcora_g2o_get_edges.restype = None
    lib.dcora_g2o_get_edges.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_g2o_free.restype = None
    lib.dcora_g2o_free.argtypes = [ct.c_void_p]

    lib.dcora_pyfg_parse.restype = ct.c_void_p
    lib.dcora_pyfg_parse.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.dcora_pyfg_dim.restype = ct.c_int
    lib.dcora_pyfg_dim.argtypes = [ct.c_void_p]
    lib.dcora_pyfg_count.restype = ct.c_int64
    lib.dcora_pyfg_count.argtypes = [ct.c_void_p, ct.c_int]
    lib.dcora_pyfg_get_gt_poses.restype = None
    lib.dcora_pyfg_get_gt_poses.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_gt_landmarks.restype = None
    lib.dcora_pyfg_get_gt_landmarks.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p,
    ]
    lib.dcora_pyfg_get_pose_priors.restype = None
    lib.dcora_pyfg_get_pose_priors.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_landmark_priors.restype = None
    lib.dcora_pyfg_get_landmark_priors.argtypes = [
        ct.c_void_p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_rel_pose_pose.restype = None
    lib.dcora_pyfg_get_rel_pose_pose.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p,
        _f64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_rel_pose_landmark.restype = None
    lib.dcora_pyfg_get_rel_pose_landmark.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_get_ranges.restype = None
    lib.dcora_pyfg_get_ranges.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
        _i64p, _f64p, _f64p, _f64p,
    ]
    lib.dcora_pyfg_free.restype = None
    lib.dcora_pyfg_free.argtypes = [ct.c_void_p]

    lib.dcora_jacobi_precond.restype = ct.c_int
    lib.dcora_jacobi_precond.argtypes = [
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int, ct.c_double,
        ct.c_int64, _i64p, _i64p, _f64p, _f64p, _f64p, _f64p,
        ct.c_int64, _i64p, _i64p, _f64p, _f64p, _f64p,
        ct.c_int64, _i64p, _i64p, _i64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, _f64p,
    ]


def get_library():
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DCORA_NATIVE", "1") == "0":
        return None
    if not _build_library():
        return None
    try:
        lib = ct.CDLL(_LIB_PATH)
        _declare(lib)
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return get_library() is not None


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------


class G2oArrays:
    """Flat-array view of a parsed g2o file."""

    def __init__(self, dim, v_ids, v_R, v_t, e_i, e_j, e_R, e_t, e_kappa,
                 e_tau):
        self.dim = dim
        self.v_ids = v_ids
        self.v_R = v_R
        self.v_t = v_t
        self.e_i = e_i
        self.e_j = e_j
        self.e_R = e_R
        self.e_t = e_t
        self.e_kappa = e_kappa
        self.e_tau = e_tau


def parse_g2o(path: str) -> Optional[G2oArrays]:
    lib = get_library()
    if lib is None:
        return None
    err = ct.create_string_buffer(512)
    h = lib.dcora_g2o_parse(path.encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode() or f"g2o parse failed: {path}")
    try:
        d = lib.dcora_g2o_dim(h)
        nv = lib.dcora_g2o_num_vertices(h)
        ne = lib.dcora_g2o_num_edges(h)
        v_ids = np.empty(nv, np.int64)
        v_R = np.empty((nv, d, d))
        v_t = np.empty((nv, d))
        lib.dcora_g2o_get_vertices(h, v_ids, v_R, v_t)
        e_i = np.empty(ne, np.int64)
        e_j = np.empty(ne, np.int64)
        e_R = np.empty((ne, d, d))
        e_t = np.empty((ne, d))
        e_kappa = np.empty(ne)
        e_tau = np.empty(ne)
        lib.dcora_g2o_get_edges(h, e_i, e_j, e_R, e_t, e_kappa, e_tau)
        return G2oArrays(d, v_ids, v_R, v_t, e_i, e_j, e_R, e_t, e_kappa,
                         e_tau)
    finally:
        lib.dcora_g2o_free(h)


class PyfgArrays:
    """Flat-array view of a parsed PyFG file.  ``seq`` arrays give the
    file-order position of each relative measurement across all kinds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse_pyfg(path: str) -> Optional[PyfgArrays]:
    lib = get_library()
    if lib is None:
        return None
    err = ct.create_string_buffer(512)
    h = lib.dcora_pyfg_parse(path.encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode() or f"pyfg parse failed: {path}")
    try:
        d = lib.dcora_pyfg_dim(h)
        cnt = [lib.dcora_pyfg_count(h, k) for k in range(7)]
        ngp, ngl, npp, npl, mpp, mpl, mrg = cnt

        gp_robot = np.empty(ngp, np.int64)
        gp_state = np.empty(ngp, np.int64)
        gp_R = np.empty((ngp, d, d))
        gp_t = np.empty((ngp, d))
        lib.dcora_pyfg_get_gt_poses(h, gp_robot, gp_state, gp_R, gp_t)

        gl_robot = np.empty(ngl, np.int64)
        gl_state = np.empty(ngl, np.int64)
        gl_t = np.empty((ngl, d))
        lib.dcora_pyfg_get_gt_landmarks(h, gl_robot, gl_state, gl_t)

        prp_robot = np.empty(npp, np.int64)
        prp_state = np.empty(npp, np.int64)
        prp_R = np.empty((npp, d, d))
        prp_t = np.empty((npp, d))
        prp_kappa = np.empty(npp)
        prp_tau = np.empty(npp)
        lib.dcora_pyfg_get_pose_priors(
            h, prp_robot, prp_state, prp_R, prp_t, prp_kappa, prp_tau
        )

        prl_robot = np.empty(npl, np.int64)
        prl_state = np.empty(npl, np.int64)
        prl_t = np.empty((npl, d))
        prl_tau = np.empty(npl)
        lib.dcora_pyfg_get_landmark_priors(
            h, prl_robot, prl_state, prl_t, prl_tau
        )

        pp = {k: np.empty(mpp, np.int64) for k in
              ("seq", "r1", "p1", "r2", "p2")}
        pp_R = np.empty((mpp, d, d))
        pp_t = np.empty((mpp, d))
        pp_kappa = np.empty(mpp)
        pp_tau = np.empty(mpp)
        lib.dcora_pyfg_get_rel_pose_pose(
            h, pp["seq"], pp["r1"], pp["p1"], pp["r2"], pp["p2"],
            pp_R, pp_t, pp_kappa, pp_tau,
        )

        pl = {k: np.empty(mpl, np.int64) for k in
              ("seq", "r1", "p1", "r2", "p2")}
        pl_t = np.empty((mpl, d))
        pl_tau = np.empty(mpl)
        lib.dcora_pyfg_get_rel_pose_landmark(
            h, pl["seq"], pl["r1"], pl["p1"], pl["r2"], pl["p2"],
            pl_t, pl_tau,
        )

        rg = {k: np.empty(mrg, np.int64) for k in
              ("seq", "r1", "p1", "st1", "r2", "p2", "st2", "l")}
        rg_range = np.empty(mrg)
        rg_prec = np.empty(mrg)
        rg_u = np.empty((mrg, d))
        lib.dcora_pyfg_get_ranges(
            h, rg["seq"], rg["r1"], rg["p1"], rg["st1"], rg["r2"],
            rg["p2"], rg["st2"], rg["l"], rg_range, rg_prec, rg_u,
        )

        return PyfgArrays(
            dim=d,
            gp_robot=gp_robot, gp_state=gp_state, gp_R=gp_R, gp_t=gp_t,
            gl_robot=gl_robot, gl_state=gl_state, gl_t=gl_t,
            prp_robot=prp_robot, prp_state=prp_state, prp_R=prp_R,
            prp_t=prp_t, prp_kappa=prp_kappa, prp_tau=prp_tau,
            prl_robot=prl_robot, prl_state=prl_state, prl_t=prl_t,
            prl_tau=prl_tau,
            pp=pp, pp_R=pp_R, pp_t=pp_t, pp_kappa=pp_kappa, pp_tau=pp_tau,
            pl=pl, pl_t=pl_t, pl_tau=pl_tau,
            rg=rg, rg_range=rg_range, rg_prec=rg_prec, rg_u=rg_u,
        )
    finally:
        lib.dcora_pyfg_free(h)


# --------------------------------------------------------------------------
# preconditioner assembly
# --------------------------------------------------------------------------


def jacobi_precond(n: int, nsph: int, nlmk: int, d: int, reg: float,
                   pp_ri, pp_rj, pp_t, pp_kappa, pp_tau, pp_w,
                   pl_ri, pl_tj, pl_t, pl_tau, pl_w,
                   rg_ti, rg_tj, rg_q, rg_rho, rg_prec, rg_w):
    """Native block-Jacobi assembly + inversion.  Returns
    (pose_inv [n,d+1,d+1], sph_diag [nsph], lmk_diag [nlmk]) or None when
    the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None

    def i64(a):
        return np.ascontiguousarray(np.asarray(a), np.int64)

    def f64(a):
        return np.ascontiguousarray(np.asarray(a), np.float64)

    pose_inv = np.zeros((n, d + 1, d + 1))
    sph_diag = np.zeros(nsph)
    lmk_diag = np.zeros(nlmk)
    rc = lib.dcora_jacobi_precond(
        n, nsph, nlmk, d, reg,
        len(pp_ri), i64(pp_ri), i64(pp_rj), f64(pp_t), f64(pp_kappa),
        f64(pp_tau), f64(pp_w),
        len(pl_ri), i64(pl_ri), i64(pl_tj), f64(pl_t), f64(pl_tau),
        f64(pl_w),
        len(rg_ti), i64(rg_ti), i64(rg_tj), i64(rg_q), f64(rg_rho),
        f64(rg_prec), f64(rg_w),
        pose_inv, sph_diag, lmk_diag,
    )
    if rc != 0:
        raise ValueError("preconditioner pose block not positive definite")
    return pose_inv, sph_diag, lmk_diag
