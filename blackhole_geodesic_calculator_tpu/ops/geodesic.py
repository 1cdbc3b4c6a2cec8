"""Batched null-geodesic right-hand sides -- the integrator hot path.

The reference solves the geodesic equation per ray with scipy ``solve_ivp`` on
8 first-order ODEs in (x^beta, k^alpha) (reference README.md:196-211, called
once per pixel per sample at
/root/reference/raytracer/RelativisticRenderEngine.py:293-294).  Here the same
physics is reformulated for batched accelerator execution:

* **Hamiltonian form with conserved energy.**  For any Kerr-Schild metric
  g = eta + 2H l l (covering flat H=0, Schwarzschild H=M/r and Kerr), the
  super-Hamiltonian of a photon is

      Hh = 1/2 g^{mu nu} p_mu p_nu
         = 1/2 (-E^2 + |p|^2) - H(x) (E + l(x).p)^2

  with p_t = -E exactly conserved (static metric).  Only the 6 quantities
  (x_i, p_i) are evolved -- 6 ODEs instead of the reference's 8, no Christoffel
  contraction (64 terms) in the inner loop, and no coordinate singularity at
  the horizon (Kerr-Schild is horizon-penetrating), so no stiffness control is
  needed where the reference's adaptive RK45 grinds down.

* **Identical physics.**  Kerr-Schild shares its spatial coordinates with the
  reference's Schwarzschild chart (only t is resummed), so spatial photon paths
  x(lambda), deflection angles, disk crossings and the shadow are identical.
  The affine parameter is normalized the same way: the initial coordinate
  velocity dx/dlambda equals the unit camera ray direction, matching the
  reference's unit-k0 convention (RelativisticRenderEngine.py:227-230,287).

All functions are shaped for batches: ``x3, p3: (..., 3)``; scalars ``(...,)``.
Everything is pure and jit/vmap/grad-safe.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.kerr import ks_radius, ks_scalars

Array = jax.Array


_R2_FLOOR = 1e-12  # keeps captured rays finite until the capture test freezes them


def _schwarzschild_scalars(x3, mass):
    """(2H, l3, r) for a = 0: 2H = r_s/r, l3 = x/r -- cheapest form."""
    r2 = jnp.maximum(jnp.sum(x3 * x3, axis=-1), _R2_FLOOR)
    inv_r = jax.lax.rsqrt(r2)
    r = r2 * inv_r
    return (2.0 * mass) * inv_r, x3 * inv_r[..., None], r


def ks_fields(x3, mass, a):
    """(q, l3, r) with q = 2H for the Kerr-Schild family; a may be None/0."""
    if a is None:
        return _schwarzschild_scalars(x3, mass)
    H, l3 = ks_scalars(x3, mass, a)
    return 2.0 * H, l3, ks_radius(x3, a)


def null_init(x3: Array, d: Array, mass, a=None) -> tuple[Array, Array]:
    """Initial (p3, E) of a photon at ``x3`` with coordinate velocity ``d``.

    ``d`` must be unit-norm (the camera produces normalized directions, as in
    the reference at RelativisticRenderEngine.py:230).  Closed form from the
    null condition Hh = 0 and dx/dlambda = d:

        s = l.d,  E = sqrt(1 - q (1 - s^2)),  w = (E + s)/(1 - q),
        p = d + q w l,                         q = 2H.
    """
    q, l3, _ = ks_fields(x3, mass, a)
    s = jnp.sum(l3 * d, axis=-1)
    # The argument is positive outside the horizon; the guard (instead of a
    # bare max) keeps the jacobian finite for inside-horizon rays whose
    # zero cotangents would otherwise turn into NaN (0 * inf).
    e2 = 1.0 - q * (1.0 - s * s)
    E = jnp.sqrt(jnp.where(e2 > 0, e2, 1.0)) * (e2 > 0)
    w = (E + s) / (1.0 - q)
    p = d + (q * w)[..., None] * l3
    return p, E


def timelike_init(x3: Array, v: Array, mass, a=None) -> tuple[Array, Array]:
    """Initial (p3, E) of a MASSIVE particle at ``x3`` with proper-time
    coordinate velocity ``dx/dtau = v`` (any magnitude; the reference's
    ``time_like=True`` flag, RelativisticRenderEngine.py:134).

    Closed form from the timelike normalization g_{mu nu} u^mu u^nu = -1
    with u = (T, v) in the Kerr-Schild chart (g = eta + 2H l l,
    l_mu = (1, l_i)):

        (q - 1) T^2 + 2 q s T + (|v|^2 + q s^2 + 1) = 0,    q = 2H, s = l.v
        T = (q s + sqrt(q^2 s^2 + (1 - q)(|v|^2 + q s^2 + 1))) / (1 - q)
        p_i = v_i + q (T + s) l_i,        E = -p_t = T - q (T + s)

    picking the future root (flat limit: T = sqrt(1 + |v|^2), p = v -- the
    special-relativistic 4-velocity).  The geodesic RHS is UNCHANGED: the
    super-Hamiltonian Hh = 1/2(-E^2 + |p|^2) - H w^2 has the same
    x-dependence for massive and massless particles; only its conserved
    value differs (-1/2 instead of 0), so the same integrator, events and
    Pallas kernels apply verbatim.
    """
    q, l3, _ = ks_fields(x3, mass, a)
    s = jnp.sum(l3 * v, axis=-1)
    v2 = jnp.sum(v * v, axis=-1)
    one_m_q = 1.0 - q
    disc = q * q * s * s + one_m_q * (v2 + q * s * s + 1.0)
    # guarded sqrt/divide: starting inside the horizon (q >= 1) has no
    # future-timelike solution with this chart split; zero out like
    # null_init does so frozen INSIDE_HORIZON rays stay NaN-free.
    valid = (disc > 0) & (one_m_q > 0)
    T = (q * s + jnp.sqrt(jnp.where(valid, disc, 1.0))) / jnp.where(
        valid, one_m_q, 1.0)
    T = jnp.where(valid, T, 1.0)
    qc = q * (T + s)
    p = v + qc[..., None] * l3
    E = T - qc
    return p, E


def xdot(x3: Array, p3: Array, E: Array, mass, a=None) -> Array:
    """Coordinate velocity dx/dlambda = dHh/dp = p - q (E + l.p) l."""
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + jnp.sum(l3 * p3, axis=-1)
    return p3 - (q * w)[..., None] * l3


def schwarzschild_rhs(x3: Array, p3: Array, E: Array, mass) -> tuple[Array, Array]:
    """Hand-derived (dx, dp) for Schwarzschild-KS -- the fused hot kernel body.

    With n = x/r, u = 2M/r, s = n.p, w = E + s:

        dx_i = p_i - u w n_i
        dp_i = -(M/r^2) [ w^2 n_i - 2 w (p_i - s n_i) ]

    Verified against autodiff of the Hamiltonian (ks_rhs) in tests.
    ~40 VPU flops + one rsqrt per ray per evaluation.
    """
    r2 = jnp.maximum(jnp.sum(x3 * x3, axis=-1), _R2_FLOOR)
    inv_r = jax.lax.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    n = x3 * inv_r[..., None]
    u = (2.0 * mass) * inv_r
    s = jnp.sum(n * p3, axis=-1)
    w = E + s
    dx = p3 - (u * w)[..., None] * n
    m_r2 = mass * inv_r2
    coef_p = 2.0 * m_r2 * w
    coef_n = m_r2 * w * (w + 2.0 * s)  # from -(w^2 n) - 2 w s n collected on n
    dp = coef_p[..., None] * p3 - coef_n[..., None] * n
    return dx, dp


def _ks_potential(x3, p3, E, mass, a):
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + jnp.sum(l3 * p3, axis=-1)
    return 0.5 * jnp.sum(q * w * w)


def ks_rhs(x3: Array, p3: Array, E: Array, mass, a=None) -> tuple[Array, Array]:
    """Generic KS-family (dx, dp) via autodiff of the Hamiltonian potential.

    dp = -dHh/dx = +d/dx [ H (E + l.p)^2 ]; exact for flat, Schwarzschild and
    Kerr.  The Schwarzschild case has a cheaper hand-derived twin
    (schwarzschild_rhs); this one is the reference implementation and the Kerr
    path.
    """
    dx = xdot(x3, p3, E, mass, a)
    dp = jax.grad(_ks_potential)(x3, p3, E, mass, a)
    return dx, dp


def hamiltonian(x3: Array, p3: Array, E: Array, mass, a=None) -> Array:
    """Hh = 1/2(-E^2 + |p|^2) - H (E + l.p)^2; exactly 0 along null geodesics.

    The conservation-law analogue of the reference's null condition
    g_{mu nu} k^mu k^nu = 0 (time_like=False,
    RelativisticRenderEngine.py:134); used as an in-flight accuracy monitor.
    """
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + jnp.sum(l3 * p3, axis=-1)
    return 0.5 * (-E * E + jnp.sum(p3 * p3, axis=-1) - q * w * w)
