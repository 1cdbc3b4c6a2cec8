"""Batched geodesic integration with online event detection.

This layer replaces the reference's per-pixel scipy ``solve_ivp`` calls
(adaptive RK45, <=10000 stored points per ray,
/root/reference/raytracer/RelativisticRenderEngine.py:293-294) with one jitted
program over the whole ray batch:

* **RK4 fixed-step** under ``lax.scan`` -- differentiable end to end, with
  ``jax.checkpoint`` over step segments so the backward sweep needs
  O(sqrt(n_steps)) memory instead of storing every state.
* **Dormand-Prince 5(4) adaptive** under ``lax.while_loop`` -- the parity twin
  of scipy's RK45 core, forward-only, exits as soon as every ray terminated.
* **Online events**: instead of materializing the trajectory polyline and
  scanning it afterwards (reference ``checkHitDisk`` at
  LimitedRelativisticRenderEngine.py:413-438 and the Blender ``ray_cast``
  re-casts at :319), disk crossings and sphere hits are detected per step on
  the current segment and recorded in the carry.  Nothing is ever stored per
  step, so HBM traffic is just the O(state) carry.

Termination semantics mirror the reference exactly: horizon capture
(``hit_blackhole``), escape from the domain, affine budget ``curve_end``
(scene property ``integration_depth``, default 50,
RelativisticRenderEngine.py:508,61), camera-inside-horizon, and an ERROR
status standing in for the reference's red-pixel 'Outside' taxonomy
(LimitedRelativisticRenderEngine.py:311-314).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

from . import states
from .states import RayState
from .geodesic import (ks_rhs, schwarzschild_rhs, null_init,
                       timelike_init, xdot)
from ..models.kerr import ks_radius

Array = jax.Array
_INF = jnp.inf


# =============================================================================
# Environment: everything the integrator needs to know about the spacetime,
# the termination geometry and the event geometry.
# =============================================================================
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DiskGeom:
    """z = 0 annulus, the reference accretion disk (checkHitDisk geometry)."""

    r_in: Array
    r_out: Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SphereGeom:
    """K scene spheres (moons / orbiting stars); centers (K, 3), radii (K,)."""

    center: Array
    radius: Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GeodesicEnv:
    """Traced physical parameters; None fields statically disable a feature."""

    mass: Any
    r_capture: Any
    r_escape: Any
    lam_max: Any
    spin: Any = None          # None -> Schwarzschild closed-form fast path
    disk: DiskGeom | None = None
    spheres: SphereGeom | None = None

    def rhs(self, x3, p3, E):
        if self.spin is None:
            return schwarzschild_rhs(x3, p3, E, self.mass)
        return ks_rhs(x3, p3, E, self.mass, self.spin)

    def radius(self, x3):
        if self.spin is None:
            return jnp.sqrt(jnp.sum(x3 * x3, axis=-1))
        return ks_radius(x3, self.spin)


# =============================================================================
# Static integrator configuration.
# =============================================================================
@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    n_steps: int = 512
    dt: float = 0.1
    method: str = "rk4"          # 'rk4' | 'dopri'
    mode: str = "scan"           # 'scan' (differentiable) | 'while' (fast fwd)
    # 'auto': the fused RK4 kernel (ops/pallas_kernel.py) on a GPU, the XLA
    # scan elsewhere; 'scan' forces XLA, 'pallas' forces the kernel (GPU only).
    backend: str = "auto"
    remat_segment: int = 0       # 0 -> sqrt(n_steps); 1 -> no remat
    # Per-ray radius-proportional step growth: far from the hole curvature
    # ~ M/r^2 is tiny, so steps can stretch.
    #   dt_eff = dt * clip((r/r_ref)^dt_power, 1, boost)
    # dt_power > 1 grows steps super-linearly in the far field, where the
    # per-step bending ~ (2 M b / r^3) dt_eff still DECAYS as long as
    # dt_power < 3 -- validated against the f64 oracle in
    # tests/test_native.py::test_bench_schedule_accuracy.
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0  # 0 -> 6 M (twice the photon sphere)
    dt_power: float = 1.0
    # Dormand-Prince controls (parity with scipy solve_ivp defaults rtol=1e-3,
    # atol=1e-6; reference passes max_step through, RelativisticRenderEngine.py:293)
    rtol: float = 1e-5
    atol: float = 1e-8
    max_step: float = _INF
    min_step: float = 1e-6


# =============================================================================
# Single steps.
# =============================================================================
def rk4_step(env: GeodesicEnv, x, p, E, dt):
    """Classic RK4 on the 6-dim (x, p) Hamiltonian system; dt is per-ray."""
    h = dt[..., None]

    k1x, k1p = env.rhs(x, p, E)
    k2x, k2p = env.rhs(x + 0.5 * h * k1x, p + 0.5 * h * k1p, E)
    k3x, k3p = env.rhs(x + 0.5 * h * k2x, p + 0.5 * h * k2p, E)
    k4x, k4p = env.rhs(x + h * k3x, p + h * k3p, E)

    sixth = 1.0 / 6.0
    x1 = x + h * sixth * (k1x + 2.0 * (k2x + k3x) + k4x)
    p1 = p + h * sixth * (k1p + 2.0 * (k2p + k3p) + k4p)
    return x1, p1


# Dormand-Prince 5(4) Butcher tableau (same pair as scipy's RK45).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (
    5179 / 57600,
    0.0,
    7571 / 16695,
    393 / 640,
    -92097 / 339200,
    187 / 2100,
    1 / 40,
)


def dopri_step(env: GeodesicEnv, x, p, E, dt):
    """One embedded Dormand-Prince 5(4) step; returns (x5, p5, err_norm_sq)."""
    h = dt[..., None]
    kx, kp = [], []
    for i in range(7):
        xi, pi = x, p
        for j, aij in enumerate(_DP_A[i]):
            xi = xi + h * aij * kx[j]
            pi = pi + h * aij * kp[j]
        dxi, dpi = env.rhs(xi, pi, E)
        kx.append(dxi)
        kp.append(dpi)

    def comb(ks, bs):
        out = 0.0
        for k, b in zip(ks, bs):
            if b != 0.0:
                out = out + b * k
        return out

    x5 = x + h * comb(kx, _DP_B5)
    p5 = p + h * comb(kp, _DP_B5)
    ex = h * comb(kx, tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4)))
    ep = h * comb(kp, tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4)))
    return x5, p5, ex, ep


# =============================================================================
# Event detection on one segment  x0 -> x1  (straight-segment semantics,
# exactly the reference's polyline treatment of the trajectory).
# =============================================================================
def _disk_event(env: GeodesicEnv, x0, x1):
    """First z=0 crossing inside the annulus; returns (t in [0,1] or inf, point).

    Reference: crossing test + linear interpolation + annulus test at
    LimitedRelativisticRenderEngine.py:416-424.
    """
    z0, z1 = x0[..., 2], x1[..., 2]
    crossed = ((z1 < 0) & (z0 >= 0)) | ((z1 > 0) & (z0 <= 0))
    denom = z1 - z0
    t = -z0 / jnp.where(jnp.abs(denom) > 0, denom, 1.0)
    pt = x0 + (x1 - x0) * t[..., None]
    rr = jnp.sqrt(pt[..., 0] ** 2 + pt[..., 1] ** 2)
    hit = crossed & (rr >= env.disk.r_in) & (rr <= env.disk.r_out)
    pt = pt.at[..., 2].set(0.0)
    return jnp.where(hit, t, _INF), pt


def _sphere_events(env: GeodesicEnv, x0, x1):
    """Earliest sphere intersection on the segment; (t or inf, point, id).

    Replaces the reference's Blender BVH ``scene.ray_cast`` calls
    (LimitedRelativisticRenderEngine.py:224,319) with analytic
    segment-vs-sphere tests, vectorized over the K spheres.
    """
    c = env.spheres.center          # (K, 3)
    rad = env.spheres.radius        # (K,)
    d = (x1 - x0)[..., None, :]     # (..., 1, 3)
    o = x0[..., None, :] - c        # (..., K, 3)
    aa = jnp.sum(d * d, axis=-1)
    bb = 2.0 * jnp.sum(o * d, axis=-1)
    cc = jnp.sum(o * o, axis=-1) - rad * rad
    disc = bb * bb - 4.0 * aa * cc
    # sqrt(max(disc, 0)) has a 0*inf = NaN jacobian exactly where clamped
    # (all missing rays); guard the unselected branch so zero cotangents
    # stay zero instead of poisoning shared parameters.
    sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
    t = (-bb - sq) / jnp.where(aa > 0, 2.0 * aa, 1.0)
    valid = (disc > 0) & (t >= 0.0) & (t <= 1.0)
    t = jnp.where(valid, t, _INF)           # (..., K)
    k_best = jnp.argmin(t, axis=-1)
    t_best = jnp.min(t, axis=-1)
    # Guard the miss branch: x0 + 0*inf is NaN forward and NaN-jacobian
    # backward even under a zero cotangent (which is dense, not symbolic).
    t_pt = jnp.where(jnp.isfinite(t_best), t_best, 0.0)
    pt = x0 + (x1 - x0) * t_pt[..., None]
    obj = jnp.where(jnp.isfinite(t_best), k_best, -1).astype(jnp.int32)
    return t_best, pt, obj


def _apply_events(env: GeodesicEnv, s: RayState, x1, p1, dt) -> RayState:
    """Classify the step x->x1 and merge results into the frozen-state carry."""
    active = s.active

    # --- segment events -------------------------------------------------
    t_disk = _INF
    if env.disk is not None:
        t_disk, disk_pt = _disk_event(env, s.x, x1)
    t_sph = _INF
    if env.spheres is not None:
        t_sph, sph_pt, sph_obj = _sphere_events(env, s.x, x1)

    # --- endpoint events ------------------------------------------------
    r1 = env.radius(x1)
    lam1 = s.lam + dt
    finite = jnp.all(jnp.isfinite(x1), axis=-1) & jnp.all(
        jnp.isfinite(p1), axis=-1
    )
    captured = r1 <= env.r_capture
    escaped = r1 >= env.r_escape
    budget = lam1 >= env.lam_max

    # Priority: earliest segment event (disk/sphere), then ERROR, CAPTURED,
    # ESCAPED, BUDGET -- matching the reference's dispatch order where a disk
    # crossing found on the trajectory wins over the capture classification
    # (LimitedRelativisticRenderEngine.py:283-314).
    status = jnp.where(budget, states.BUDGET, states.ACTIVE)
    status = jnp.where(escaped, states.ESCAPED, status)
    status = jnp.where(captured, states.CAPTURED, status)
    status = jnp.where(~finite, states.ERROR, status)
    if env.spheres is not None:
        status = jnp.where(jnp.isfinite(t_sph), states.OBJECT, status)
    if env.disk is not None:
        disk_wins = jnp.isfinite(t_disk) & (t_disk <= t_sph)
        status = jnp.where(disk_wins, states.DISK, status)

    status = jnp.where(active, status, s.status)

    # --- merge (frozen rays keep their state; never store non-finite) ----
    # Event rays freeze AT the interpolated event point: x becomes the
    # crossing location and lam gets the fractional step, so shading inputs
    # are functions of (x, p) alone (see RayState docstring).
    upd = (active & finite)[..., None]
    new = dataclasses.replace(
        s,
        x=jnp.where(upd, x1, s.x),
        p=jnp.where(upd, p1, s.p),
        lam=jnp.where(active, lam1, s.lam),
        status=status,
    )
    if env.spheres is not None:
        sel = active & (status == states.OBJECT)
        ts = jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)
        new.x = jnp.where(sel[..., None], sph_pt, new.x)
        new.lam = jnp.where(sel, s.lam + dt * ts, new.lam)
        new.hit_obj = jnp.where(sel, sph_obj, new.hit_obj)
    if env.disk is not None:
        sel = active & (status == states.DISK)
        td = jnp.where(jnp.isfinite(t_disk), t_disk, 0.0)
        new.x = jnp.where(sel[..., None], disk_pt, new.x)
        new.lam = jnp.where(sel, s.lam + dt * td, new.lam)
    return new


# =============================================================================
# Drivers.
# =============================================================================
def _dt_eff(env: GeodesicEnv, cfg: IntegratorConfig, s: RayState):
    dt = jnp.where(s.active, cfg.dt, 0.0)
    if cfg.dt_boost > 1.0:
        r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
        r = env.radius(s.x)
        ratio = r / r_ref
        if cfg.dt_power == 1.5:          # cheap sqrt form of the hot case
            ratio = ratio * jnp.sqrt(jnp.maximum(ratio, 0.0))
        elif cfg.dt_power == 2.0:
            ratio = ratio * ratio
        elif cfg.dt_power != 1.0:
            ratio = jnp.maximum(ratio, 1e-20) ** cfg.dt_power
        dt = dt * jnp.clip(ratio, 1.0, cfg.dt_boost)
    return dt


def _fixed_step(env: GeodesicEnv, cfg: IntegratorConfig, s: RayState) -> RayState:
    dt = _dt_eff(env, cfg, s)
    x1, p1 = rk4_step(env, s.x, s.p, s.E, dt)
    return _apply_events(env, s, x1, p1, dt)


def _segments(cfg: IntegratorConfig):
    """(seg, n_full, rem): remat segment length, full segments, tail steps."""
    seg = cfg.remat_segment or max(1, int(cfg.n_steps**0.5))
    return seg, cfg.n_steps // seg, cfg.n_steps % seg


def integrate_fixed(env: GeodesicEnv, s0: RayState, cfg: IntegratorConfig) -> RayState:
    """RK4 scan -- differentiable, remat-checkpointed in segments.

    Runs EXACTLY cfg.n_steps steps: full remat segments plus an un-remated
    tail of n_steps % seg (a ceil'd segment count would silently
    over-integrate every ray whenever seg does not divide n_steps)."""
    seg, n_full, rem = _segments(cfg)

    def body(s, _):
        return _fixed_step(env, cfg, s), None

    def one_segment(s, _):
        s, _ = lax.scan(body, s, None, length=seg)
        return s, None

    segf = jax.checkpoint(one_segment) if seg > 1 else one_segment
    s = s0
    if n_full:
        s, _ = lax.scan(segf, s, None, length=n_full)
    if rem:
        s, _ = lax.scan(body, s, None, length=rem)
    return s


def integrate_fixed_fast(env, s0, cfg: IntegratorConfig) -> RayState:
    """RK4 while_loop -- forward-only, exits once every ray has terminated."""

    def cond(carry):
        s, i = carry
        return (i < cfg.n_steps) & jnp.any(s.active)

    def body(carry):
        s, i = carry
        return _fixed_step(env, cfg, s), i + 1

    s, _ = lax.while_loop(cond, body, (s0, jnp.asarray(0, jnp.int32)))
    return s


def integrate_adaptive(env: GeodesicEnv, s0: RayState, cfg: IntegratorConfig):
    """Dormand-Prince 5(4) with per-ray step control (scipy-RK45 parity path).

    Forward-only (while_loop).  Per-ray h adapts on the embedded error with the
    standard 0.2-power controller; rejected steps retry with smaller h.
    Returns (final RayState, per-ray accepted-step counts).
    """
    h0 = jnp.minimum(cfg.dt, cfg.max_step)
    h = jnp.full(s0.E.shape, h0, s0.x.dtype)
    nacc = jnp.zeros(s0.E.shape, jnp.int32)

    def cond(carry):
        s, h, nacc, i = carry
        return (i < cfg.n_steps) & jnp.any(s.active)

    def body(carry):
        s, h, nacc, i = carry
        dt = jnp.where(s.active, h, 0.0)
        x5, p5, ex, ep = dopri_step(env, s.x, s.p, s.E, dt)
        scale_x = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(s.x), jnp.abs(x5))
        scale_p = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(s.p), jnp.abs(p5))
        # double-where guard: sqrt has an infinite derivative at 0, and
        # frozen rays (dt = 0) have exactly zero embedded error -- without
        # the guard the adjoint turns their zero cotangent into NaN.
        err2 = (jnp.sum((ex / scale_x) ** 2, -1)
                + jnp.sum((ep / scale_p) ** 2, -1)) / 6.0
        err = jnp.where(err2 > 0, jnp.sqrt(jnp.where(err2 > 0, err2, 1.0)),
                        0.0)
        accept = (err <= 1.0) | (h <= cfg.min_step)
        # Frozen rays neither accept nor rescale.
        accept = accept & s.active
        s1 = _apply_events(env, s, x5, p5, dt)
        s = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(accept, accept.shape + (1,) * (a.ndim - accept.ndim)),
                b,
                a,
            ),
            s,
            s1,
        )
        factor = 0.9 * jnp.where(err > 0, err, 1e-10) ** -0.2
        factor = jnp.clip(factor, 0.2, 5.0)
        h = jnp.where(
            s.active, jnp.clip(h * factor, cfg.min_step, cfg.max_step), h
        )
        return s, h, nacc + accept.astype(jnp.int32), i + 1

    s, _, nacc, _ = lax.while_loop(
        cond, body, (s0, h, nacc, jnp.asarray(0, jnp.int32))
    )
    return s, nacc


def integrate_adaptive_scan(env: GeodesicEnv, s0: RayState,
                            cfg: IntegratorConfig) -> RayState:
    """Differentiable Dormand-Prince 5(4): the SAME per-ray accept/reject
    controller as ``integrate_adaptive``, but under a fixed-trip-count
    remat-checkpointed ``lax.scan`` so ``jax.grad`` works end to end.

    This is the exact discrete adjoint of the adaptive scheme
    (discretize-then-optimize): the step-size controller is part of the
    differentiated program, so gradients account for h's dependence on the
    state.  Frozen/converged rays run masked no-op trips (dt = 0), which is
    what buys the static trip count the scan needs; use mode='while'
    (``integrate_adaptive``) for the cheaper forward-only twin.  Parity
    with the while-loop path is tested (same discrete trajectory).
    """
    h0 = jnp.minimum(cfg.dt, cfg.max_step)
    h_init = jnp.full(s0.E.shape, h0, s0.x.dtype)

    def body(carry, _):
        s, h = carry
        dt = jnp.where(s.active, h, 0.0)
        x5, p5, ex, ep = dopri_step(env, s.x, s.p, s.E, dt)
        scale_x = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(s.x), jnp.abs(x5))
        scale_p = cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(s.p), jnp.abs(p5))
        # double-where guard: sqrt has an infinite derivative at 0, and
        # frozen rays (dt = 0) have exactly zero embedded error -- without
        # the guard the adjoint turns their zero cotangent into NaN.
        err2 = (jnp.sum((ex / scale_x) ** 2, -1)
                + jnp.sum((ep / scale_p) ** 2, -1)) / 6.0
        err = jnp.where(err2 > 0, jnp.sqrt(jnp.where(err2 > 0, err2, 1.0)),
                        0.0)
        accept = ((err <= 1.0) | (h <= cfg.min_step)) & s.active
        s1 = _apply_events(env, s, x5, p5, dt)
        s = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(accept,
                            accept.shape + (1,) * (a.ndim - accept.ndim)),
                b, a),
            s, s1,
        )
        factor = 0.9 * jnp.where(err > 0, err, 1e-10) ** -0.2
        factor = jnp.clip(factor, 0.2, 5.0)
        h = jnp.where(
            s.active, jnp.clip(h * factor, cfg.min_step, cfg.max_step), h
        )
        return (s, h), None

    seg, n_full, rem = _segments(cfg)

    def one_segment(carry, _):
        carry, _ = lax.scan(body, carry, None, length=seg)
        return carry, None

    segf = jax.checkpoint(one_segment) if seg > 1 else one_segment
    carry = (s0, h_init)
    if n_full:
        carry, _ = lax.scan(segf, carry, None, length=n_full)
    if rem:
        carry, _ = lax.scan(body, carry, None, length=rem)
    return carry[0]


def _use_pallas(cfg: IntegratorConfig) -> bool:
    """Whether the RK4 kernel serves ``cfg``: 'auto' picks it on a GPU;
    'pallas' demands it and raises where there is no GPU to compile for."""
    if cfg.backend not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.backend == "scan" or cfg.method != "rk4":
        if cfg.backend == "pallas":
            raise ValueError("backend='pallas' serves method='rk4' only")
        return False
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backend == "pallas" and not on_gpu:
        raise RuntimeError("backend='pallas' needs a GPU (the kernel compiles "
                           "through Triton); use backend='auto' or 'scan'")
    return on_gpu


def integrate(env: GeodesicEnv, s0: RayState, cfg: IntegratorConfig) -> RayState:
    if cfg.method not in ("rk4", "dopri"):
        raise ValueError(f"unknown method {cfg.method!r}")
    if _use_pallas(cfg):
        from .pallas_kernel import integrate_pallas

        return integrate_pallas(env, s0, cfg)
    if cfg.method == "dopri":
        if cfg.mode == "while":       # forward-only fast path
            return integrate_adaptive(env, s0, cfg)[0]
        return integrate_adaptive_scan(env, s0, cfg)
    if cfg.mode == "while":
        return integrate_fixed_fast(env, s0, cfg)
    return integrate_fixed(env, s0, cfg)


# =============================================================================
# Launch helper + trajectory recorder (debug / test parity with the
# reference's stored `nr_points_curve` polylines).
# =============================================================================
def launch(env: GeodesicEnv, x0, d0, cfg: IntegratorConfig,
           time_like: bool = False) -> RayState:
    """Init rays at x0 with coordinate velocities d0, then integrate.

    ``time_like=False`` (photons): d0 must be unit directions.
    ``time_like=True`` (massive particles, the reference's flag at
    RelativisticRenderEngine.py:134): d0 is dx/dtau of any magnitude.
    Rays starting inside the horizon are marked INSIDE_HORIZON immediately,
    mirroring the reference's ``start_inside_hole``
    (RelativisticRenderEngine.py:296,311-313).
    """
    init = timelike_init if time_like else null_init
    p0, E0 = init(x0, d0, env.mass, env.spin)
    s0 = states.init_state(x0, p0, E0)
    inside = env.radius(x0) <= env.r_capture
    s0.status = jnp.where(inside, states.INSIDE_HORIZON, s0.status)
    return integrate(env, s0, cfg)


def trajectory(env: GeodesicEnv, x0, d0, cfg: IntegratorConfig,
               time_like: bool = False):
    """(xs, ps, states) with xs: (n_steps+1, ..., 3) -- the reference's
    ``calc_trajectory`` equivalent for small batches/tests; stores every step.
    """
    init = timelike_init if time_like else null_init
    p0, E0 = init(x0, d0, env.mass, env.spin)
    s0 = states.init_state(x0, p0, E0)

    def body(s, _):
        s = _fixed_step(env, cfg, s)
        return s, (s.x, s.p)

    s, (xs, ps) = lax.scan(body, s0, None, length=cfg.n_steps)
    xs = jnp.concatenate([s0.x[None], xs], axis=0)
    ps = jnp.concatenate([s0.p[None], ps], axis=0)
    return xs, ps, s


def final_direction(env: GeodesicEnv, s: RayState) -> Array:
    """Unit coordinate velocity at the final state -- the reference's
    ``end_dir`` used for the background lookup (RelativisticRenderEngine.py:308,
    246).  Far from the hole dx/dlambda -> p, but we evaluate exactly.
    """
    v = xdot(s.x, s.p, s.E, env.mass, env.spin)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
