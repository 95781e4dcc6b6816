"""Host-side local graph bookkeeping.

The Python counterpart of the reference's Graph (include/DCORA/Graph.h,
src/Graph.cpp): measurement classification (odometry / private / shared loop
closures), ownership and neighbor-slot resolution, robust weights, activity
gating, priors, and statistics. It compiles the measurement set into the
device-side SoA (:class:`dcora_tpu.core.problem.ProblemData`).

Fixed neighbor public states occupy *augmented slots* appended after the
local variables (see problem.py). A missing required neighbor state means the
subproblem is not solvable this round (reference: Graph::constructG returning
false -> skip optimization, Agent.cpp:1243-1249).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import jax.numpy as jnp

from dcora_tpu.core import lifted, problem
from dcora_tpu.core.lifted import RAState
from dcora_tpu.core.problem import ProblemData
from dcora_tpu.measurements import (
    RangeMeasurement,
    RelativePoseLandmarkMeasurement,
    RelativePosePoseMeasurement,
)
from dcora_tpu.types import (
    EdgeID,
    GraphType,
    ProblemDims,
    StateID,
    StateType,
    PoseID,
    UnitSphereID,
    LandmarkID,
)

PRIOR_KAPPA = 10000.0  # reference: Graph.cpp:29
PRIOR_TAU = 100.0  # reference: Graph.cpp:30


class GraphStatistics:
    def __init__(self, total=0.0, accept=0.0, reject=0.0):
        self.total_loop_closures = total
        self.accept_loop_closures = accept
        self.reject_loop_closures = reject
        self.undecided_loop_closures = total - accept - reject


class LocalGraph:
    """Per-agent measurement store and SoA compiler."""

    def __init__(self, robot_id: int, r: int, d: int,
                 graph_type: GraphType = GraphType.PoseGraph):
        self.id = robot_id
        self.r = r
        self.d = d
        self.graph_type = graph_type
        self.empty()

    # ------------------------------------------------------------------ data
    def empty(self):
        self.n = 0
        self.l = 0  # noqa: E741
        self.b = 0
        self.odometry: List[RelativePosePoseMeasurement] = []
        self.private_lcs: List[object] = []
        self.shared_lcs: List[object] = []
        self._edge_ids: Dict[EdgeID, object] = {}
        self.neighbor_active: Dict[int, bool] = {}
        self.pose_priors: Dict[int, np.ndarray] = {}  # idx -> lifted [r, d+1]
        self.landmark_priors: Dict[int, np.ndarray] = {}  # idx -> lifted [r]
        self._invalidate()

    def _invalidate(self):
        self._compiled = None
        self.version = getattr(self, "version", 0) + 1

    @property
    def dims(self) -> ProblemDims:
        return ProblemDims(self.d, self.n, self.l, self.b)

    def is_pgo_compatible(self) -> bool:
        if self.graph_type == GraphType.RangeAidedSLAMGraph:
            return False
        assert self.l == 0 and self.b == 0
        return True

    def set_measurements(self, measurements: List[object]):
        self.empty()
        for m in measurements:
            self.add_measurement(m)

    def add_measurement(self, m):
        if m.r1 != self.id and m.r2 != self.id:
            return  # irrelevant edge (reference: Graph.cpp:122-125)
        eid = m.edge_id()
        if eid in self._edge_ids:
            return  # duplicate
        self._edge_ids[eid] = m
        # update dimensions from owned states
        for robot, idx, st in ((m.r1, m.p1, m.stateType1),
                               (m.r2, m.p2, m.stateType2)):
            if robot == self.id:
                if st == StateType.Pose:
                    self.n = max(self.n, idx + 1)
                elif st == StateType.Landmark:
                    self.b = max(self.b, idx + 1)
        if isinstance(m, RangeMeasurement) and m.r1 == self.id:
            self.l = max(self.l, m.l + 1)  # noqa: E741
        # classify
        if m.r1 == self.id and m.r2 == self.id:
            if (isinstance(m, RelativePosePoseMeasurement)
                    and m.p1 + 1 == m.p2):
                self.odometry.append(m)
            else:
                self.private_lcs.append(m)
        else:
            self.shared_lcs.append(m)
            nbr = m.r2 if m.r1 == self.id else m.r1
            self.neighbor_active.setdefault(nbr, True)
        self._invalidate()

    def find_measurement(self, eid: EdgeID):
        return self._edge_ids.get(eid)

    def all_measurements(self) -> List[object]:
        return self.odometry + self.private_lcs + self.shared_lcs

    def local_measurements(self) -> List[object]:
        return self.odometry + self.private_lcs

    def loop_closures(self) -> List[object]:
        return self.private_lcs + self.shared_lcs

    def active_loop_closures(self) -> List[object]:
        out = list(self.private_lcs)
        for m in self.shared_lcs:
            nbr = m.r2 if m.r1 == self.id else m.r1
            if self.neighbor_active.get(nbr, True):
                out.append(m)
        return out

    def shared_loop_closures_with_robot(self, nbr: int) -> List[object]:
        return [m for m in self.shared_lcs if nbr in (m.r1, m.r2)]

    def neighbor_ids(self) -> Set[int]:
        return set(self.neighbor_active.keys())

    def has_neighbor(self, nbr: int) -> bool:
        return nbr in self.neighbor_active

    def is_neighbor_active(self, nbr: int) -> bool:
        return self.neighbor_active.get(nbr, False)

    def set_neighbor_active(self, nbr: int, active: bool):
        if self.neighbor_active.get(nbr) != active:
            self.neighbor_active[nbr] = active
            self._invalidate()

    # ---------------------------------------------------------------- priors
    def set_prior(self, index: int, lifted_pose: np.ndarray):
        """Anchor pose `index` with a lifted prior [r, d+1].

        reference: Graph::setPrior / Agent::anchorFirstPose.

        Design delta: the reference adds only the prior's *linear* term to
        the cost (Graph.cpp:805-817, with its own "TODO: Treat priors as
        relative measurements"), which leaves the prior energy unbounded
        below along the translation null space.  Here the full quadratic
        form kappa||Y-P||^2 + tau||p-q||^2 is used: the kappa I / tau
        diagonal enters Q (problem.ProblemData.prior_kdiag/tdiag) so the
        gradient vanishes exactly at the prior.
        """
        assert lifted_pose.shape == (self.r, self.d + 1)
        self.pose_priors[index] = np.asarray(lifted_pose)
        self._invalidate()

    def set_landmark_prior(self, index: int, lifted_point: np.ndarray):
        """Anchor landmark `index` with a lifted prior [r].

        reference: Graph::setPrior(unsigned, const LiftedPoint&)
        (Graph.cpp:326-331).
        """
        assert lifted_point.shape == (self.r,)
        assert 0 <= index < self.b
        self.landmark_priors[index] = np.asarray(lifted_point)
        self._invalidate()

    def clear_priors(self):
        self.pose_priors.clear()
        self.landmark_priors.clear()
        self._invalidate()

    # -------------------------------------------------------------- statistics
    def statistics(self) -> GraphStatistics:
        total = accept = reject = 0.0
        for m in self.private_lcs:
            total += 1
            if m.weight == 1:
                accept += 1
            elif m.weight == 0:
                reject += 1
        for m in self.shared_lcs:
            nbr = m.r2 if m.r1 == self.id else m.r1
            if not self.neighbor_active.get(nbr, True):
                continue
            total += 1
            if m.weight == 1:
                accept += 1
            elif m.weight == 0:
                reject += 1
        return GraphStatistics(total, accept, reject)

    # ------------------------------------------------------------- public ids
    def my_public_state_ids(self) -> Tuple[Set[StateID], Set[StateID], Set[StateID]]:
        """(pose_ids, unit_sphere_ids, landmark_ids) owned by me and shared.

        reference: Graph.h:420-435 (myPublicPoseIDs etc.). A state is public
        if it appears in a shared measurement, and for range measurements the
        unit-sphere variable is public when the *other* endpoint's robot
        differs from its owner.
        """
        poses, spheres, landmarks = set(), set(), set()
        for m in self.shared_lcs:
            for robot, idx, st in ((m.r1, m.p1, m.stateType1),
                                   (m.r2, m.p2, m.stateType2)):
                if robot != self.id:
                    continue
                if st == StateType.Pose:
                    poses.add(PoseID(robot, idx))
                else:
                    landmarks.add(LandmarkID(robot, idx))
            if isinstance(m, RangeMeasurement) and m.r1 == self.id:
                # sphere owned by me on a shared edge -> public
                spheres.add(UnitSphereID(self.id, m.l))
        return poses, spheres, landmarks

    # --------------------------------------------------------------- compile
    def _compile(self):
        """Assign fixed-neighbor slots and build index arrays."""
        if self._compiled is not None:
            return self._compiled

        n, b = self.n, self.b
        fixed_pose: Dict[StateID, int] = {}
        fixed_trans: Dict[StateID, int] = {}
        fixed_sphere: Dict[StateID, int] = {}

        def pose_slots(sid: StateID):
            if sid not in fixed_pose:
                fixed_pose[sid] = len(fixed_pose)
                fixed_trans[sid] = len(fixed_trans)
            return fixed_pose[sid], fixed_trans[sid]

        def trans_slot(sid: StateID):
            if sid.state_type == StateType.Pose:
                return pose_slots(sid)[1]
            if sid not in fixed_trans:
                fixed_trans[sid] = len(fixed_trans)
            return fixed_trans[sid]

        def sphere_slot(sid: StateID):
            if sid not in fixed_sphere:
                fixed_sphere[sid] = len(fixed_sphere)
            return fixed_sphere[sid]

        def rot_index(robot, idx):
            if robot == self.id:
                return idx
            return None  # resolved after slot count known

        # first pass: resolve endpoints symbolically
        pp_rows, pl_rows, rg_rows = [], [], []
        pp_meas, pl_meas, rg_meas = [], [], []

        def trans_index_local(idx, st):
            return idx if st == StateType.Pose else n + idx

        for m in self.all_measurements():
            owned1 = m.r1 == self.id
            owned2 = m.r2 == self.id
            nbr = None if (owned1 and owned2) else (m.r2 if owned1 else m.r1)
            if isinstance(m, RelativePosePoseMeasurement):
                ri = m.p1 if owned1 else ("P", pose_slots(m.src_id()))
                rj = m.p2 if owned2 else ("P", pose_slots(m.dst_id()))
                pp_rows.append((ri, rj, nbr))
                pp_meas.append(m)
            elif isinstance(m, RelativePoseLandmarkMeasurement):
                ri = m.p1 if owned1 else ("P", pose_slots(m.src_id()))
                tj = (trans_index_local(m.p2, StateType.Landmark)
                      if owned2 else ("T", trans_slot(m.dst_id())))
                pl_rows.append((ri, tj, nbr))
                pl_meas.append(m)
            elif isinstance(m, RangeMeasurement):
                ta = (trans_index_local(m.p1, m.stateType1)
                      if owned1 else ("T", trans_slot(m.src_id())))
                tb = (trans_index_local(m.p2, m.stateType2)
                      if owned2 else ("T", trans_slot(m.dst_id())))
                q = (m.l if m.r1 == self.id
                     else ("S", sphere_slot(m.unit_sphere_id())))
                rg_rows.append((ta, tb, q, nbr))
                rg_meas.append(m)
            else:
                raise TypeError(type(m))

        n_fix_pose = len(fixed_pose)
        n_fix_trans = len(fixed_trans)
        n_fix_sphere = len(fixed_sphere)

        def res_rot(x):
            if isinstance(x, tuple):
                return n + x[1][0]
            return x

        def res_trans_from_pose(x, local_idx_fn):
            # x is either local pose idx (int) or ("P", (pslot, tslot))
            if isinstance(x, tuple):
                return n + b + x[1][1]
            return local_idx_fn(x)

        def res_trans(x):
            if isinstance(x, tuple):
                return n + b + x[1]
            return x

        def res_sphere(x):
            if isinstance(x, tuple):
                return self.l + x[1]
            return x

        pp_idx = np.array(
            [
                (
                    res_rot(ri),
                    res_rot(rj),
                    res_trans_from_pose(ri, lambda i: i),
                    res_trans_from_pose(rj, lambda i: i),
                )
                for ri, rj, _ in pp_rows
            ],
            dtype=np.int32,
        ).reshape(-1, 4)
        pl_idx = np.array(
            [
                (
                    res_rot(ri),
                    res_trans_from_pose(ri, lambda i: i),
                    res_trans(tj),
                )
                for ri, tj, _ in pl_rows
            ],
            dtype=np.int32,
        ).reshape(-1, 3)
        rg_idx = np.array(
            [
                (res_trans(ta), res_trans(tb), res_sphere(q))
                for ta, tb, q, _ in rg_rows
            ],
            dtype=np.int32,
        ).reshape(-1, 3)

        self._compiled = dict(
            pp_idx=pp_idx, pl_idx=pl_idx, rg_idx=rg_idx,
            pp_meas=pp_meas, pl_meas=pl_meas, rg_meas=rg_meas,
            pp_nbr=[x[2] for x in pp_rows],
            pl_nbr=[x[2] for x in pl_rows],
            rg_nbr=[x[3] for x in rg_rows],
            fixed_pose=fixed_pose, fixed_trans=fixed_trans,
            fixed_sphere=fixed_sphere,
            n_fix_pose=n_fix_pose, n_fix_trans=n_fix_trans,
            n_fix_sphere=n_fix_sphere,
        )
        return self._compiled

    # ------------------------------------------------------- required states
    def required_neighbor_states(self):
        c = self._compile()
        return (set(c["fixed_pose"]), set(c["fixed_sphere"]),
                {s for s in c["fixed_trans"]
                 if s.state_type == StateType.Landmark})

    def requires_neighbor_pose(self, sid: StateID) -> bool:
        return sid in self._compile()["fixed_pose"]

    def requires_neighbor_sphere(self, sid: StateID) -> bool:
        return sid in self._compile()["fixed_sphere"]

    def requires_neighbor_landmark(self, sid: StateID) -> bool:
        c = self._compile()
        return sid in c["fixed_trans"] and sid.state_type == StateType.Landmark

    # ----------------------------------------------------------- SoA export
    def problem_data(self, r: Optional[int] = None) -> ProblemData:
        """Build the device SoA at rank r (default self.r)."""
        r = self.r if r is None else r
        c = self._compile()
        d = self.d

        def weights_and_active(meas_list, nbr_list):
            w = np.array([m.weight for m in meas_list], dtype=np.float64)
            act = np.array(
                [
                    1.0 if (nbr is None or self.neighbor_active.get(nbr, True))
                    else 0.0
                    for nbr in nbr_list
                ],
                dtype=np.float64,
            )
            return w, act

        pp_w, pp_a = weights_and_active(c["pp_meas"], c["pp_nbr"])
        pl_w, pl_a = weights_and_active(c["pl_meas"], c["pl_nbr"])
        rg_w, rg_a = weights_and_active(c["rg_meas"], c["rg_nbr"])

        pp_R = np.array([m.R for m in c["pp_meas"]], dtype=np.float64).reshape(
            -1, d, d
        )
        pp_t = np.array([m.t for m in c["pp_meas"]], dtype=np.float64).reshape(
            -1, d
        )
        pl_t = np.array([m.t for m in c["pl_meas"]], dtype=np.float64).reshape(
            -1, d
        )

        prior_G = None
        prior_kdiag = prior_tdiag = None
        if self.pose_priors or self.landmark_priors:
            G = lifted.zeros(self.dims, r)
            rot = np.zeros((self.n, r, d))
            trn = np.zeros((self.n + self.b, r))
            kdiag = np.zeros(self.n)
            tdiag = np.zeros(self.n + self.b)
            for idx, P in self.pose_priors.items():
                assert P.shape == (r, d + 1), (P.shape, r, d)
                rot[idx] -= PRIOR_KAPPA * P[:, :d]
                trn[idx] -= PRIOR_TAU * P[:, d]
                kdiag[idx] += PRIOR_KAPPA
                tdiag[idx] += PRIOR_TAU
            for idx, tP in self.landmark_priors.items():
                # landmark priors: declared by the reference API
                # (Graph.cpp:326-331) but never folded into its cost; here
                # they act like pose-translation priors with PRIOR_TAU
                trn[self.n + idx] -= PRIOR_TAU * tP
                tdiag[self.n + idx] += PRIOR_TAU
            prior_G = RAState(
                rot=jnp.asarray(rot), sph=G.sph, trn=jnp.asarray(trn)
            )
            prior_kdiag = jnp.asarray(kdiag)
            prior_tdiag = jnp.asarray(tdiag)

        return ProblemData(
            pp_ri=jnp.asarray(c["pp_idx"][:, 0]),
            pp_rj=jnp.asarray(c["pp_idx"][:, 1]),
            pp_ti=jnp.asarray(c["pp_idx"][:, 2]),
            pp_tj=jnp.asarray(c["pp_idx"][:, 3]),
            pp_R=jnp.asarray(pp_R),
            pp_t=jnp.asarray(pp_t),
            pp_kappa=jnp.asarray([m.kappa for m in c["pp_meas"]]),
            pp_tau=jnp.asarray([m.tau for m in c["pp_meas"]]),
            pp_w=jnp.asarray(pp_w),
            pp_active=jnp.asarray(pp_a),
            pl_ri=jnp.asarray(c["pl_idx"][:, 0]),
            pl_ti=jnp.asarray(c["pl_idx"][:, 1]),
            pl_tj=jnp.asarray(c["pl_idx"][:, 2]),
            pl_t=jnp.asarray(pl_t),
            pl_tau=jnp.asarray([m.tau for m in c["pl_meas"]]),
            pl_w=jnp.asarray(pl_w),
            pl_active=jnp.asarray(pl_a),
            rg_ti=jnp.asarray(c["rg_idx"][:, 0]),
            rg_tj=jnp.asarray(c["rg_idx"][:, 1]),
            rg_q=jnp.asarray(c["rg_idx"][:, 2]),
            rg_rho=jnp.asarray([m.range for m in c["rg_meas"]]),
            rg_prec=jnp.asarray([m.precision for m in c["rg_meas"]]),
            rg_w=jnp.asarray(rg_w),
            rg_active=jnp.asarray(rg_a),
            prior_G=prior_G,
            prior_kdiag=prior_kdiag,
            prior_tdiag=prior_tdiag,
            ell=self._build_ell(c, d, pp_w * pp_a, pl_w * pl_a, rg_w * rg_a,
                                prior_kdiag, prior_tdiag),
        )

    def _build_ell(self, c, d, pp_wa, pl_wa, rg_wa,
                   prior_kdiag=None, prior_tdiag=None):
        """ELL form of the local Q (gather fast path); None when disabled."""
        import os

        if os.environ.get("DCORA_ELL", "1") == "0":
            return None
        pp_kappa = np.array([m.kappa for m in c["pp_meas"]])
        pp_tau = np.array([m.tau for m in c["pp_meas"]])
        pl_tau = np.array([m.tau for m in c["pl_meas"]])
        rg_prec = np.array([m.precision for m in c["rg_meas"]])
        pp_R = np.array([m.R for m in c["pp_meas"]]).reshape(-1, d, d)
        pp_t = np.array([m.t for m in c["pp_meas"]]).reshape(-1, d)
        pl_t = np.array([m.t for m in c["pl_meas"]]).reshape(-1, d)
        return problem.build_ell(
            self.n, self.l, self.b, d,
            c["pp_idx"][:, 0], c["pp_idx"][:, 1],
            c["pp_idx"][:, 2], c["pp_idx"][:, 3],
            pp_R, pp_t, pp_kappa * pp_wa, pp_tau * pp_wa,
            c["pl_idx"][:, 0], c["pl_idx"][:, 1], c["pl_idx"][:, 2],
            pl_t, pl_tau * pl_wa,
            c["rg_idx"][:, 0], c["rg_idx"][:, 1], c["rg_idx"][:, 2],
            np.array([m.range for m in c["rg_meas"]]), rg_prec * rg_wa,
            kdiag=prior_kdiag, tdiag=prior_tdiag,
        )

    def fixed_state(self, pose_dict: Dict[StateID, np.ndarray],
                    sphere_dict: Dict[StateID, np.ndarray],
                    landmark_dict: Dict[StateID, np.ndarray],
                    r: Optional[int] = None):
        """Assemble the fixed-slot RAState from neighbor caches.

        Returns (RAState, all_present). Missing states are zero-filled and
        flagged (reference behaviour: skip optimization, Agent.cpp:1243-1249).
        Inactive neighbors' states are not required (their edges are gated by
        the activity mask).
        """
        r = self.r if r is None else r
        c = self._compile()
        d = self.d
        rot = np.zeros((c["n_fix_pose"], r, d))
        trn = np.zeros((c["n_fix_trans"], r))
        sph = np.zeros((c["n_fix_sphere"], r))
        all_present = True

        def active(sid):
            return self.neighbor_active.get(sid.robot_id, True)

        for sid, slot in c["fixed_pose"].items():
            if sid in pose_dict:
                P = np.asarray(pose_dict[sid])
                rot[slot] = P[:, :d]
                trn[c["fixed_trans"][sid]] = P[:, d]
            elif active(sid):
                all_present = False
        for sid, slot in c["fixed_trans"].items():
            if sid.state_type == StateType.Landmark:
                if sid in landmark_dict:
                    trn[slot] = np.asarray(landmark_dict[sid]).reshape(r)
                elif active(sid):
                    all_present = False
        for sid, slot in c["fixed_sphere"].items():
            if sid in sphere_dict:
                sph[slot] = np.asarray(sphere_dict[sid]).reshape(r)
            elif active(sid):
                all_present = False

        if c["n_fix_pose"] == 0 and c["n_fix_trans"] == 0 and \
                c["n_fix_sphere"] == 0:
            return None, True
        return RAState(rot=jnp.asarray(rot), sph=jnp.asarray(sph),
                       trn=jnp.asarray(trn)), all_present
