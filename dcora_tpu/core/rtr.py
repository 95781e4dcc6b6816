"""Riemannian trust-region solver with truncated CG, in pure JAX.

JAX replacement for ROPTLIB's RTRNewton/RSD as configured by the
reference (QuadraticOptimizer.cpp:234-289): GRAD_F stopping on the Riemannian
gradient norm, Steihaug-Toint truncated CG inner loop with preconditioning,
initial radius 100 / max radius 5x, and the special one-accepted-step mode
used as the RBCD per-iteration solver (radius shrinks /4 on rejection, up to
10 tries; QuadraticOptimizer.cpp:253-273).

The solver is generic over the state representation through a *backend*
(static jit argument) providing the problem/manifold operations:

  * ``RA_BACKEND``   -- RAState pytrees + matrix-free edge-path cost engine
    (problem.py); exact residual-form numerics, f64-friendly.
  * ``FLAT_BACKEND`` -- flat [r_pad, kpad] arrays over the RCM-tiled scalar
    ordering (tiled.py); the dense-tile block-sparse SpMM path with
    elementwise per-pose ops.

Everything runs inside lax.while_loop, so one compilation serves every
staircase level (rank masking) and every RBCD iteration.

The Riemannian Hessian uses the Weingarten-corrected form for embedded
Stiefel/oblique submanifolds,

    Hess f(X)[eta] = P_T( Q eta - W(eta, egrad) ),
    W_rot_i = eta_i sym(Y_i^T egrad_i),   W_sph_q = eta_q <s_q, egrad_q>,

matching the curvature handling of ROPTLIB's EucHvToHv that the reference
relies on via QuadraticProblem::EucHessianEta.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dcora_tpu.core import problem as prob
from dcora_tpu.core.lifted import RAState
from dcora_tpu.core.manifold import retract, tangent_project
from dcora_tpu.core.problem import Preconditioner, ProblemData


# --------------------------------------------------------------------------
# generic pytree algebra (works for RAState and bare arrays alike)
# --------------------------------------------------------------------------


def tvdot(a, b):
    return sum(
        jnp.vdot(x, y)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def tnorm(a):
    return jnp.sqrt(tvdot(a, a))


def tscale(a, s):
    return jax.tree.map(lambda x: s * x, a)


def tadd(a, b):
    return jax.tree.map(jnp.add, a, b)


def taxpy(s, x, y):
    """y + s * x."""
    return jax.tree.map(lambda xi, yi: yi + s * xi, x, y)


def twhere(c, a, b):
    return jax.tree.map(lambda ai, bi: jnp.where(c, ai, bi), a, b)


@dataclasses.dataclass(frozen=True)
class RTRConfig:
    gradnorm_tol: float = 1e-2
    max_outer: int = 3
    max_inner: int = 50
    initial_radius: float = 100.0
    max_radius_factor: float = 5.0
    # tCG kappa/theta stopping rule
    kappa: float = 0.1
    theta: float = 1.0
    rho_accept: float = 0.1
    # Manopt-style rho regularization: near convergence the actual decrease
    # f(X) - f(X+) is dominated by eps*|f| cancellation noise, making rho
    # garbage and stalling the solver ~6 digits above the achievable
    # gradnorm.  Adding reg = rho_regularization*eps*max(1,|f|) to both
    # numerator and denominator drives rho -> 1 for noise-level steps.
    rho_regularization: float = 1e3
    # Run the tCG inner loop in float32 while the outer RTR (gradient,
    # cost, rho, retraction) stays in the data dtype.  Mixed precision:
    # an inexact Newton direction does not limit the achievable gradient norm
    # -- the f64 gradient and rho test do.  Ignored when the data is
    # already float32.
    tcg_f32: bool = False
    # one-accepted-step mode (RBCD): shrink radius /4 on rejection, <=10 tries
    single_accepted_step: bool = False
    max_rejections: int = 10


# --------------------------------------------------------------------------
# backends
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RABackend:
    """RAState + edge-path cost engine (problem.py)."""

    def cost(self, P, G, X):
        return prob.cost(P, X, G)

    def egrad(self, P, G, X):
        return prob.euclidean_gradient(P, X, G)

    def hessvec(self, P, V):
        return prob.hessian_vec(P, V)

    def applyQ(self, P, X):
        """X Q for cost/gradient: the residual-form edge path, which avoids
        the ~6-digit cancellation of the assembled (ELL) matrix near the
        optimum (see problem.apply_Q numerics note)."""
        return prob.apply_Q(P, X, prefer_ell=False)

    def tangent(self, P, X, V):
        return tangent_project(X, V)

    def hess_setup(self, P, X, egrad):
        """Per-outer-iteration constants of the Weingarten map: egrad is
        fixed during tCG, so sym(Y^T egrad) is computed once, not per
        Hessian application."""
        S = 0.5 * (
            jnp.einsum("nri,nrj->nij", X.rot, egrad.rot)
            + jnp.einsum("nrj,nri->nij", X.rot, egrad.rot)
        )
        s_inner = jnp.sum(X.sph * egrad.sph, axis=-1, keepdims=True)
        return (S, s_inner)

    def weingarten(self, P, X, eta, aux):
        S, s_inner = aux
        w_rot = jnp.einsum("nrd,nde->nre", eta.rot, S)
        w_sph = eta.sph * s_inner
        return RAState(rot=w_rot, sph=w_sph, trn=jnp.zeros_like(eta.trn))

    def precond(self, P, M, X, V):
        if M is None:
            return V  # V is already tangent
        return tangent_project(X, prob.apply_preconditioner(M, V))

    def retract(self, P, X, V):
        return retract(X, V)


@dataclasses.dataclass(frozen=True)
class _FlatBackend:
    """Flat [r_pad, kpad] arrays over the tiled scalar ordering (tiled.py).

    P is a tiled.TiledProblem (preconditioner included); M is ignored.
    """

    def cost(self, P, G, X):
        from dcora_tpu.core import tiled

        return tiled.cost_flat(P, X, G)

    def egrad(self, P, G, X):
        from dcora_tpu.core import tiled

        return tiled.egrad_flat(P, X, G)

    def hessvec(self, P, V):
        from dcora_tpu.core import tiled

        return tiled.apply_tiled(P, V)

    def applyQ(self, P, X):
        from dcora_tpu.core import tiled

        return tiled.apply_tiled(P, X)

    def tangent(self, P, X, V):
        from dcora_tpu.core import tiled

        return tiled.tangent_project_flat(P.meta, X, V)

    def hess_setup(self, P, X, egrad):
        from dcora_tpu.core import tiled

        return tiled.weingarten_setup(P.meta, X, egrad)

    def weingarten(self, P, X, eta, aux):
        from dcora_tpu.core import tiled

        return tiled.weingarten_apply(P.meta, eta, aux)

    def precond(self, P, M, X, V):
        from dcora_tpu.core import tiled

        return tiled.tangent_project_flat(
            P.meta, X, tiled.precondition_flat(P, V)
        )

    def retract(self, P, X, V):
        from dcora_tpu.core import tiled

        return tiled.retract_flat(P.meta, X, V)


@dataclasses.dataclass(frozen=True)
class _PlanarBackend:
    """Planar pytree state over the tiled scalar ordering (tiled.Planar).

    Same problem data as _FlatBackend (P is a tiled.TiledProblem), but the
    tCG state keeps pose components as [r_pad, n] slices so all
    manifold/preconditioner ops are straight-line elementwise arithmetic; the
    interleaved flat layout is materialized only around the SpMM.
    """

    def cost(self, P, G, X):
        from dcora_tpu.core import tiled

        Xf = tiled.from_planar(P.meta, X)
        f = 0.5 * jnp.vdot(tiled.apply_tiled(P, Xf), Xf)
        if G is not None:
            f = f + tvdot(X, G)
        return f

    def egrad(self, P, G, X):
        W = self.applyQ(P, X)
        return W if G is None else tadd(W, G)

    def hessvec(self, P, V):
        return self.applyQ(P, V)

    def applyQ(self, P, X):
        from dcora_tpu.core import tiled

        return tiled.to_planar(
            P.meta, tiled.apply_tiled(P, tiled.from_planar(P.meta, X)))

    def tangent(self, P, X, V):
        from dcora_tpu.core import tiled

        return tiled.tangent_project_planar(P.meta, X, V)

    def hess_setup(self, P, X, egrad):
        from dcora_tpu.core import tiled

        return tiled.weingarten_setup_planar(P.meta, X, egrad)

    def weingarten(self, P, X, eta, aux):
        from dcora_tpu.core import tiled

        return tiled.weingarten_apply_planar(P.meta, eta, aux)

    def precond(self, P, M, X, V):
        from dcora_tpu.core import tiled

        return tiled.tangent_project_planar(
            P.meta, X, tiled.precondition_planar(P, V)
        )

    def retract(self, P, X, V):
        from dcora_tpu.core import tiled

        return tiled.retract_planar(P.meta, X, V)


RA_BACKEND = _RABackend()
FLAT_BACKEND = _FlatBackend()
PLANAR_BACKEND = _PlanarBackend()


def riemannian_gradient(P: ProblemData, X: RAState, G: RAState) -> RAState:
    return tangent_project(X, prob.euclidean_gradient(P, X, G))


def riemannian_hessian_vec(P: ProblemData, X: RAState, eta: RAState,
                           egrad: RAState) -> RAState:
    aux = RA_BACKEND.hess_setup(P, X, egrad)
    return _rhess(RA_BACKEND, P, X, eta, aux)


def _rhess(be, P, X, eta, aux):
    H = be.hessvec(P, eta)
    H = jax.tree.map(jnp.subtract, H, be.weingarten(P, X, eta, aux))
    return be.tangent(P, X, H)


class TCGResult(NamedTuple):
    eta: object
    Heta: object
    inner_iters: jax.Array


def truncated_cg(P, X, grad, egrad, M, radius, max_inner: int,
                 kappa: float, theta: float, be=RA_BACKEND) -> TCGResult:
    """Preconditioned Steihaug-Toint tCG for the trust-region subproblem."""
    zero = jax.tree.map(jnp.zeros_like, grad)

    r0 = grad
    z0 = be.precond(P, M, X, r0)
    d0 = tscale(z0, -1.0)
    r0_norm = tnorm(r0)
    stop_tol = r0_norm * jnp.minimum(kappa, r0_norm**theta)

    hess_aux = be.hess_setup(P, X, egrad)

    def hess(eta):
        return _rhess(be, P, X, eta, hess_aux)

    def boundary_tau(eta, d, radius):
        # largest tau >= 0 with ||eta + tau d|| = radius
        dd = tvdot(d, d)
        ed = tvdot(eta, d)
        ee = tvdot(eta, eta)
        disc = jnp.maximum(ed * ed - dd * (ee - radius**2), 0.0)
        return (-ed + jnp.sqrt(disc)) / jnp.where(dd == 0, 1.0, dd)

    State = tuple  # (eta, Heta, r, z, d, rz, it, done)

    def cond(s: State):
        _, _, _, _, _, _, it, done = s
        return jnp.logical_and(it < max_inner, jnp.logical_not(done))

    def body(s: State):
        eta, Heta, r, z, d, rz, it, done = s
        Hd = hess(d)
        dHd = tvdot(d, Hd)
        alpha = rz / jnp.where(dHd == 0, 1.0, dHd)
        eta_next = taxpy(alpha, d, eta)
        hit = jnp.logical_or(dHd <= 0, tnorm(eta_next) >= radius)

        tau = boundary_tau(eta, d, radius)
        eta_b = taxpy(tau, d, eta)
        Heta_b = taxpy(tau, Hd, Heta)

        eta_new = twhere(hit, eta_b, eta_next)
        Heta_new = twhere(hit, Heta_b, taxpy(alpha, Hd, Heta))
        r_new = taxpy(alpha, Hd, r)
        z_new = be.precond(P, M, X, r_new)
        rz_new = tvdot(r_new, z_new)
        small = tnorm(r_new) <= stop_tol
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        d_new = taxpy(beta, d, tscale(z_new, -1.0))
        done_new = jnp.logical_or(hit, small)
        return (eta_new, Heta_new, r_new, z_new, d_new, rz_new, it + 1,
                done_new)

    init = (zero, zero, r0, z0, d0, tvdot(r0, z0), jnp.zeros((), jnp.int32),
            r0_norm < 1e-300)
    eta, Heta, _, _, _, _, it, _ = jax.lax.while_loop(cond, body, init)
    return TCGResult(eta=eta, Heta=Heta, inner_iters=it)


def _run_tcg(P, X, grad, egrad, M, radius, cfg: "RTRConfig",
             be=RA_BACKEND) -> TCGResult:
    """Dispatch tCG at the working dtype or in float32 (cfg.tcg_f32).

    In mixed mode the returned eta is re-projected onto the f64 tangent
    space; Heta is the (f32-accurate) upcast, good enough for the
    rho-regularized acceptance test.
    """
    lead = jax.tree.leaves(grad)[0]
    if cfg.tcg_f32 and lead.dtype == jnp.float64:
        f32 = jnp.float32
        res = truncated_cg(
            _cast(P, f32), _cast(X, f32), _cast(grad, f32),
            _cast(egrad, f32), _cast(M, f32) if M is not None else None,
            jnp.asarray(radius, f32), cfg.max_inner, cfg.kappa, cfg.theta,
            be=be,
        )
        eta = be.tangent(P, X, _cast(res.eta, jnp.float64))
        return TCGResult(eta=eta, Heta=_cast(res.Heta, jnp.float64),
                         inner_iters=res.inner_iters)
    return truncated_cg(P, X, grad, egrad, M, radius, cfg.max_inner,
                        cfg.kappa, cfg.theta, be=be)


class RTRResult(NamedTuple):
    X: object
    f_final: jax.Array
    gradnorm_final: jax.Array
    outer_iters: jax.Array
    accepted: jax.Array  # whether any step was accepted
    # final trust-region radius; thread back in as `radius0` when a solve
    # is split across device calls (host chunking), otherwise every chunk
    # restarts at cfg.initial_radius and — at chunk=1 on large
    # problems — each call burns its single iteration rejecting the same
    # too-large step (tiers.pyfg rank 3 made zero progress this way)
    radius_final: Optional[jax.Array] = None


def _rtr_impl(P, G, M, X0, cfg: RTRConfig, be=RA_BACKEND,
              radius0=None) -> RTRResult:
    max_radius = cfg.initial_radius * cfg.max_radius_factor
    # The radius rides the while_loop carry at the STATE's float dtype: a
    # strongly-typed f64 radius0 entering an f32 program would promote the
    # tCG boundary step (eta + tau*d) to f64 and break the carry types;
    # the cast also gives every chunked call one jit signature regardless
    # of where the radius scalar came from.
    _fleaves = [a for a in jax.tree.leaves(X0)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype,
                                                          jnp.floating)]
    _rdt = _fleaves[0].dtype if _fleaves else jnp.float64
    rad0 = jnp.asarray(cfg.initial_radius if radius0 is None else radius0,
                       dtype=_rdt)

    # W = X Q is the expensive part of cost, gradient, and acceptance test
    # alike; the loop carries it so each outer iteration pays exactly one
    # extra SpMM (for the trial point) beyond the tCG Hessian products.
    def apply_W(X):
        return be.applyQ(P, X)

    def f_of(X, W):
        fX = 0.5 * tvdot(W, X)
        if G is not None:
            fX = fX + tvdot(X, G)
        return fX

    def egrad_of(W):
        return W if G is None else tadd(W, G)

    def rgrad_of(X, W):
        return be.tangent(P, X, egrad_of(W))

    def try_step(X, W, radius):
        """One trust-region step proposal."""
        fX = f_of(X, W)
        egrad = egrad_of(W)
        grad = be.tangent(P, X, egrad)
        res = _run_tcg(P, X, grad, egrad, M, radius, cfg, be=be)
        Xtest = be.retract(P, X, res.eta)
        Wtest = apply_W(Xtest)
        ftest = f_of(Xtest, Wtest)
        model_decrease = -(tvdot(grad, res.eta)
                           + 0.5 * tvdot(res.eta, res.Heta))
        reg = (cfg.rho_regularization * jnp.finfo(fX.dtype).eps
               * jnp.maximum(1.0, jnp.abs(fX)))
        rho = (fX - ftest + reg) / jnp.where(
            jnp.abs(model_decrease + reg) < 1e-300, 1e-300,
            model_decrease + reg,
        )
        accept = jnp.logical_and(rho > cfg.rho_accept, ftest <= fX + reg)
        X_new = twhere(accept, Xtest, X)
        W_new = twhere(accept, Wtest, W)
        hit_boundary = tnorm(res.eta) >= 0.99 * radius
        return X_new, W_new, rho, accept, hit_boundary

    W0 = apply_W(X0)

    if cfg.single_accepted_step:
        # RBCD mode (QuadraticOptimizer.cpp:253-273): keep shrinking the
        # radius (/4) until one step is accepted, or give up after
        # max_rejections tries.
        def cond(s):
            X, W, radius, it, accepted = s
            return jnp.logical_and(it <= cfg.max_rejections,
                                   jnp.logical_not(accepted))

        def body(s):
            X, W, radius, it, _ = s
            X_new, W_new, rho, accept, _ = try_step(X, W, radius)
            return (X_new, W_new, radius / 4.0, it + 1, accept)

        # skip if already below tolerance (QuadraticOptimizer.cpp:54-56)
        g0 = tnorm(rgrad_of(X0, W0))
        below = g0 < cfg.gradnorm_tol
        X, W, rad, it, accepted = jax.lax.while_loop(
            cond, body,
            (X0, W0, rad0, jnp.zeros((), jnp.int32), below),
        )
        return RTRResult(
            X=X, f_final=f_of(X, W), gradnorm_final=tnorm(rgrad_of(X, W)),
            outer_iters=it, accepted=jnp.logical_or(accepted, below),
            radius_final=rad,
        )

    def cond(s):
        X, W, radius, it, done, any_acc = s
        return jnp.logical_and(it < cfg.max_outer, jnp.logical_not(done))

    def body(s):
        X, W, radius, it, done, any_acc = s
        X_new, W_new, rho, accept, hit_boundary = try_step(X, W, radius)
        radius_new = jnp.where(
            rho < 0.25,
            radius / 4.0,
            jnp.where(
                jnp.logical_and(rho > 0.75, hit_boundary),
                jnp.minimum(2.0 * radius, max_radius),
                radius,
            ),
        )
        gnorm = tnorm(rgrad_of(X_new, W_new))
        done_new = gnorm < cfg.gradnorm_tol
        return (X_new, W_new, radius_new, it + 1, done_new,
                jnp.logical_or(any_acc, accept))

    g0 = tnorm(rgrad_of(X0, W0))
    init_done = g0 < cfg.gradnorm_tol
    X, W, rad, it, _, any_acc = jax.lax.while_loop(
        cond, body,
        (X0, W0, rad0, jnp.zeros((), jnp.int32), init_done, init_done),
    )
    return RTRResult(
        X=X, f_final=f_of(X, W), gradnorm_final=tnorm(rgrad_of(X, W)),
        outer_iters=it, accepted=any_acc, radius_final=rad,
    )


# jit wrappers: cfg/backend are static; M may be None (static in structure)
rtr = jax.jit(_rtr_impl, static_argnames=("cfg", "be"))


def rtr_flat(TP, Gf, Xf0, cfg: RTRConfig, planar: bool = True) -> RTRResult:
    """RTR on the flat tiled representation (the dense-tile fast path).

    TP: tiled.TiledProblem; Gf: flat linear term (or None); Xf0: flat state
    [r_pad, kpad] at the tile dtype.  With planar=True (default) the solve
    runs on the planar backend -- same math, fewer relayouts per inner
    iteration (see tiled.Planar) -- and converts back to the flat layout on return.
    """
    if not planar:
        return rtr(TP, Gf, None, Xf0, cfg, be=FLAT_BACKEND)
    res = _rtr_planar(TP, Gf, Xf0, cfg)
    return res


@functools.partial(jax.jit, static_argnames=("cfg",))
def _rtr_planar(TP, Gf, Xf0, cfg: RTRConfig) -> RTRResult:
    from dcora_tpu.core import tiled

    Xp0 = tiled.to_planar(TP.meta, Xf0)
    Gp = None if Gf is None else tiled.to_planar(TP.meta, Gf)
    res = _rtr_impl(TP, Gp, None, Xp0, cfg, be=PLANAR_BACKEND)
    return res._replace(X=tiled.from_planar(TP.meta, res.X))


def rtr_chunked(P, G, M, X0, cfg: RTRConfig, chunk: int = 20,
                be=RA_BACKEND) -> RTRResult:
    """Host-chunked outer loop: repeatedly run at most `chunk` outer
    iterations per device call until the gradient tolerance or the total
    budget is met.

    Rationale: the host sees progress between calls at negligible cost
    (the chunk function is compiled once), and callers cap the length of
    one device call through `chunk`.
    """
    total = 0
    X = X0
    res = None
    # trust-region radius persists across device calls; seeded as a jnp
    # scalar so every chunk shares ONE jit signature (radius0=None on the
    # first call would bake the radius as a constant and compile the RTR
    # program twice per loop); _rtr_impl re-casts it to the state dtype
    _fl = [a for a in jax.tree.leaves(X0)
           if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)]
    rad = jnp.asarray(cfg.initial_radius,
                      dtype=_fl[0].dtype if _fl else jnp.float64)
    cfg_c = dataclasses.replace(cfg, max_outer=min(chunk, cfg.max_outer))
    while total < cfg.max_outer:
        res = rtr(P, G, M, X, cfg_c, be=be, radius0=rad)
        X = res.X
        rad = res.radius_final
        total += int(res.outer_iters)
        if float(res.gradnorm_final) < cfg.gradnorm_tol or \
                int(res.outer_iters) < cfg_c.max_outer:
            break
    if res is None:
        res = rtr(P, G, M, X, dataclasses.replace(cfg, max_outer=1), be=be)
    return RTRResult(X=res.X, f_final=res.f_final,
                     gradnorm_final=res.gradnorm_final,
                     outer_iters=jnp.asarray(total),
                     accepted=res.accepted,
                     radius_final=res.radius_final)


def _cast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        tree,
    )


def rtr_mixed(P: ProblemData, G: RAState, M: Optional[Preconditioner],
              X0: RAState, cfg: RTRConfig,
              coarse_tol: float = 1e-3) -> RTRResult:
    """Mixed-precision trust region: a float32 coarse solve followed by a
    float64 refinement from the warm start. The refined result satisfies
    the same f64 gradient tolerance as a pure-f64 solve; only the path
    there changes. No reference counterpart (the reference is f64-only
    Eigen, QuadraticProblem.cpp).
    """
    grad0 = riemannian_gradient(P, X0, G).norm()
    tol32 = max(coarse_tol, cfg.gradnorm_tol)
    cfg32 = dataclasses.replace(
        cfg, gradnorm_tol=max(tol32, 1e-6 * float(grad0) + 1e-30)
    )
    res32 = rtr(_cast(P, jnp.float32), _cast(G, jnp.float32),
                _cast(M, jnp.float32) if M is not None else None,
                _cast(X0, jnp.float32), cfg32)
    from dcora_tpu.core.manifold import project

    X_warm = project(_cast(res32.X, jnp.float64))
    return rtr(P, G, M, X_warm, cfg)


def _rsd_impl(P, G, M, X0, cfg: RTRConfig, be=RA_BACKEND) -> RTRResult:
    """Riemannian steepest descent with backtracking (Armijo) line search.

    JAX replacement for the reference's ROPTLIB::RSD path
    (QuadraticOptimizer.cpp:182-232, configured at :282-289 with GRAD_F
    stop, tol 1e-2, max 10 iterations).  The search direction is the
    (optionally preconditioned) negative Riemannian gradient; the initial
    trial step exploits that f is quadratic in the embedding space --
    t0 = <g,dir>/<dir, Hess dir> is the exact minimizer pre-retraction --
    and Armijo backtracking (factor 1/2, c1=1e-4, <=25 trials) accounts for
    the retraction curvature.
    """
    max_ls = 25
    c1 = 1e-4

    def apply_W(X):
        return be.applyQ(P, X)

    def f_of(X, W):
        fX = 0.5 * tvdot(W, X)
        if G is not None:
            fX = fX + tvdot(X, G)
        return fX

    def egrad_of(W):
        return W if G is None else tadd(W, G)

    def body(s):
        X, W, it, done = s
        egrad = egrad_of(W)
        grad = be.tangent(P, X, egrad)
        direction = tscale(be.precond(P, M, X, grad), -1.0)
        gd = tvdot(grad, direction)  # < 0
        # curvature along the direction (Riemannian Hessian quadratic form)
        aux = be.hess_setup(P, X, egrad)
        Hd = _rhess(be, P, X, direction, aux)
        dHd = tvdot(direction, Hd)
        t0 = jnp.where(dHd > 0, -gd / jnp.where(dHd == 0, 1.0, dHd), 1.0)
        fX = f_of(X, W)

        def ls_cond(ls):
            t, _, _, ok, tries = ls
            return jnp.logical_and(tries < max_ls, jnp.logical_not(ok))

        def ls_body(ls):
            t, _, _, _, tries = ls
            Xt = be.retract(P, X, tscale(direction, t))
            Wt = apply_W(Xt)
            ft = f_of(Xt, Wt)
            ok = ft <= fX + c1 * t * gd
            return (t * 0.5, Xt, Wt, ok, tries + 1)

        t_fin, Xt, Wt, ok, _ = jax.lax.while_loop(
            ls_cond, ls_body, (t0, X, W, jnp.asarray(False),
                               jnp.zeros((), jnp.int32)),
        )
        X_new = twhere(ok, Xt, X)
        W_new = twhere(ok, Wt, W)
        gnorm = tnorm(be.tangent(P, X_new, egrad_of(W_new)))
        done_new = jnp.logical_or(gnorm < cfg.gradnorm_tol,
                                  jnp.logical_not(ok))
        return (X_new, W_new, it + 1, done_new)

    def cond(s):
        _, _, it, done = s
        return jnp.logical_and(it < cfg.max_outer, jnp.logical_not(done))

    W0 = apply_W(X0)
    g0 = tnorm(be.tangent(P, X0, egrad_of(W0)))
    X, W, it, _ = jax.lax.while_loop(
        cond, body,
        (X0, W0, jnp.zeros((), jnp.int32), g0 < cfg.gradnorm_tol),
    )
    return RTRResult(
        X=X, f_final=f_of(X, W),
        gradnorm_final=tnorm(be.tangent(P, X, egrad_of(W))),
        outer_iters=it, accepted=it > 0,
    )


rsd = jax.jit(_rsd_impl, static_argnames=("cfg", "be"))


def rgd_step(P: ProblemData, G: RAState, M: Optional[Preconditioner],
             X: RAState, stepsize: float) -> RAState:
    """Single preconditioned Riemannian gradient step
    (reference: QuadraticOptimizer.cpp:110-180)."""
    grad = riemannian_gradient(P, X, G)
    if M is not None:
        grad = RA_BACKEND.precond(P, M, X, grad)
    return retract(X, grad.scale(-stepsize))
