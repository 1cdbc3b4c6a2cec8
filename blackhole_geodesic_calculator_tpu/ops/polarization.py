"""Polarization transport along Schwarzschild null geodesics.

The reference lists "Add polarisation" among its open milestones
(/root/reference/README.md:217-220, unchecked); this module implements it
exactly for the Schwarzschild case, batched and differentiable.

Physics: a photon's polarization vector is parallel-transported along the
null geodesic (f.k = 0 preserved, gauge f ~ f + alpha k).  In a spherically
symmetric spacetime every null geodesic is PLANAR (the orbital plane normal
n = x cross k / |x cross k| is conserved), the plane is totally geodesic,
and reflection symmetry through it forces the transported polarization to
keep constant components in the orthonormal frame

    e_out = n                  (out of the orbital plane)
    e_in  = unit(d cross n)    (in plane, orthogonal to the ray)

i.e. Schwarzschild produces NO gravitational Faraday rotation relative to
the plane-of-motion basis (Plebanski 1960); the observable polarization
rotation is purely the geometric rotation of e_in as the ray bends.  This
closed form is exact -- no extra ODE is integrated, so the feature costs
nothing on top of the geodesic solve.

Kerr is NOT covered here: frame dragging rotates polarization relative to
this basis (the Walker-Penrose constant would be needed); passing
spin != 0 state into these helpers is a physics error, guarded at the
renderer-level entry point.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array

_EPS = 1e-12
# Geometric products in full f32: a GPU may otherwise run f32 products in
# TF32 (~3 decimal digits), coarser than one flagship pixel.
_HI = lax.Precision.HIGHEST
_dot = functools.partial(jnp.matmul, precision=_HI)
_einsum = functools.partial(jnp.einsum, precision=_HI)


def _unit(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), _EPS)


def plane_normal(x: Array, d: Array) -> Array:
    """Conserved orbital-plane normal n = unit(x cross d); for radial rays
    (|x cross d| ~ 0, which do not bend) an arbitrary fixed normal is
    returned so downstream math stays finite."""
    n = jnp.cross(x, d)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    radial = nn < 1e-8
    # any unit vector orthogonal to d works for a radial (undeflected) ray
    alt = jnp.cross(d, jnp.where(
        jnp.abs(d[..., :1]) < 0.9,
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), d.shape),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), d.shape)))
    return _unit(jnp.where(radial, alt, n))


def transport_polarization(x0: Array, d0: Array, f0: Array,
                           d1: Array) -> Array:
    """Transport polarization ``f0`` (unit, orthogonal to ``d0``) from the
    launch state (x0, d0) to the escape direction ``d1``.

    Exact for Schwarzschild: decompose f0 in the (e_out, e_in) frame at
    launch; rebuild with the SAME components in the frame at escape.
    Returns a unit vector orthogonal to d1.
    """
    n = plane_normal(x0, d0)
    e_in0 = _unit(jnp.cross(d0, n))
    e_in1 = _unit(jnp.cross(d1, n))
    a = jnp.sum(f0 * n, axis=-1, keepdims=True)
    b = jnp.sum(f0 * e_in0, axis=-1, keepdims=True)
    f1 = a * n + b * e_in1
    # exact orthogonality to d1 (float cleanup of the frame construction)
    f1 = f1 - jnp.sum(f1 * d1, axis=-1, keepdims=True) * d1
    return _unit(f1)


def polarization_rotation(x0: Array, d0: Array, d1: Array) -> Array:
    """Rotation angle (radians) of the in-plane polarization basis from
    launch to escape -- the per-pixel observable of a polarization map.
    Equals the deflection angle signed within the orbital plane; exactly 0
    in the flat limit."""
    n = plane_normal(x0, d0)
    cos = jnp.clip(jnp.sum(d0 * d1, axis=-1), -1.0, 1.0)
    # signed by the plane orientation: sin = (d0 cross d1) . n
    sin = jnp.sum(jnp.cross(d0, d1) * n, axis=-1)
    return jnp.arctan2(sin, cos)


def _ft_from_orthogonality(g, k4, f3):
    """f^t making (f^t, f3) orthogonal to k4 under metric g: f.k = f^mu k_mu
    = 0  =>  f^t = -(f^i k_i)/k_t with k_mu = g_{mu nu} k^nu."""
    k_low = _dot(g, k4)
    return -(_dot(f3, k_low[1:])) / k_low[0]


def ks_directional_christoffel(mass, a):
    """Analytic Kerr-Schild contraction Gamma^s_{mu nu} k^mu v^nu without
    ever building the (4, 4, 4) Christoffel.

    Exploits the Kerr-Schild structure g = eta + 2 H l l (l null):

        d_alpha g_{mu nu} = 2 [H_alpha l_mu l_nu
                               + H (l_{mu,alpha} l_nu + l_mu l_{nu,alpha})]
        g^{s rho}        = eta^{s rho} - 2 H l^s l^rho   (exact)

    so the contraction collapses to a handful of 3-vector products of
    (H, l) and their spatial jacobian (the only quantities differentiated
    -- via jacfwd of the ~30-flop ``ks_scalars``, not of the full metric
    build).  Measured ~4x the throughput of contracting the AD-derived
    Christoffel per RK stage; exactly equal to
    ``Metric.christoffel`` contractions (parity-tested).

    Returns ``contract(x4, k4, v4) -> Gamma^s_{mu nu} k^mu v^nu`` (shape
    (4,)); use v4 = k4 for the geodesic RHS and v4 = f4 for transport.
    """
    from ..models.kerr import ks_scalars

    def contract(x4, k4, v4):
        x3 = x4[1:]
        H, l3 = ks_scalars(x3, mass, a)
        dH, J3 = jax.jacfwd(lambda q: ks_scalars(q, mass, a))(x3)
        k0, k3v = k4[0], k4[1:]
        v0, v3v = v4[0], v4[1:]
        u = k0 + _dot(l3, k3v)            # l_mu k^mu
        w = v0 + _dot(l3, v3v)
        Hk = _dot(dH, k3v)
        Hv = _dot(dH, v3v)
        a3 = _dot(J3, k3v)                # a_i = l_{i,j} k^j  (time parts 0)
        b3 = _dot(J3, v3v)
        c3 = _dot(J3.T, k3v)              # c_j = l_{i,j} k^i
        d3v = _dot(J3.T, v3v)
        va = _dot(v3v, a3)
        kb = _dot(k3v, b3)
        # V_rho = 1/2 k^mu v^nu (d_mu g_{nu rho} + d_nu g_{rho mu}
        #                        - d_rho g_{mu nu})
        S = Hk * w + Hv * u + H * (va + kb)
        V0 = S                        # l_0 = 1, H_0 = 0, a_0 = c_0 = 0
        V3 = (S * l3 + H * (w * a3 + u * b3) - (u * w) * dH
              - H * (w * c3 + u * d3v))
        # raise with g^{s rho} = eta^{s rho} - 2 H l^s l^rho,
        # l^rho = (-1, l3)
        lv = -V0 + _dot(l3, V3)
        g0 = -V0 - 2.0 * H * (-1.0) * lv
        g3 = V3 - 2.0 * H * lv * l3
        return jnp.concatenate([g0[None], g3])

    return contract


def transport_polarization_ode(metric, x3: Array, d3: Array, f3: Array, *,
                               n_steps: int = 600, dt: float = 0.1,
                               r_stop: float = 70.0, r_capture: float = 1.0,
                               dt_boost: float = 16.0, r_ref: float = 1.6):
    """Parallel-transport polarization along null geodesics of ANY metric
    (the general path: Kerr included -- this is where gravitational Faraday
    rotation from frame dragging actually appears, unlike the Schwarzschild
    closed form above).

    Integrates the joint 12-ODE system per ray with RK4,

        dx^mu/dlam = k^mu
        dk^a /dlam = -Gamma^a_{mu nu} k^mu k^nu
        df^a /dlam = -Gamma^a_{mu nu} k^mu f^nu

    with Christoffels by forward-mode AD of the metric (models/metric.py,
    the reference's sympy-Christoffel contract made numeric).  ~40x the
    flops of the Hamiltonian hot path per step -- a diagnostics/science
    instrument, not a render-loop component.

    Args: batched launch positions ``x3``, unit directions ``d3`` (the
    affine normalization dx/dlam = d matches the main integrator) and unit
    spatial polarizations ``f3`` orthogonal to ``d3``.  Returns
    ``(f_obs, d_out, x_out, diag)``: the gauge-fixed observable unit
    polarization (f^t removed by f -> f - (f^t/k^t) k, valid in the
    asymptotically flat escape region), the escape direction, the final
    position, and a diagnostics dict with the conserved-quantity drifts
    |f.k| and |g(f,f) - 1|.
    """
    from jax import lax

    def one(x3i, d3i, f3i):
        x4 = jnp.concatenate([jnp.zeros(1), x3i])
        kt = metric.null_k_t(x4, d3i)
        k4 = jnp.concatenate([kt[None], d3i])
        g0 = metric.g(x4)
        ft = _ft_from_orthogonality(g0, k4, f3i)
        f4 = jnp.concatenate([ft[None], f3i])
        gff0 = _einsum("mn,m,n->", g0, f4, f4)

        if metric.name in ("kerr_ks", "schwarzschild_ks"):
            # Kerr-Schild fast path: analytic directional contraction
            # (ks_directional_christoffel), ~4x the generic AD path
            mass_p = metric.params[0]
            spin_p = metric.params[1] if len(metric.params) > 1 else 0.0
            kontract = ks_directional_christoffel(mass_p, spin_p)

            def rhs(x4, k4, f4):
                return (k4, -kontract(x4, k4, k4), -kontract(x4, k4, f4))
        else:
            def rhs(x4, k4, f4):
                gam = metric.christoffel(x4)
                dk = -_einsum("smn,m,n->s", gam, k4, k4)
                df = -_einsum("smn,m,n->s", gam, k4, f4)
                return k4, dk, df

        def step(carry, _):
            x4, k4, f4, alive = carry
            r = jnp.linalg.norm(x4[1:])
            h = jnp.where(alive, dt, 0.0) * jnp.clip(
                (r / r_ref) * jnp.sqrt(jnp.maximum(r / r_ref, 0.0)),
                1.0, dt_boost)
            k1 = rhs(x4, k4, f4)
            k2 = rhs(x4 + 0.5 * h * k1[0], k4 + 0.5 * h * k1[1],
                     f4 + 0.5 * h * k1[2])
            k3 = rhs(x4 + 0.5 * h * k2[0], k4 + 0.5 * h * k2[1],
                     f4 + 0.5 * h * k2[2])
            k4s = rhs(x4 + h * k3[0], k4 + h * k3[1], f4 + h * k3[2])
            s6 = h / 6.0
            x4n = x4 + s6 * (k1[0] + 2 * (k2[0] + k3[0]) + k4s[0])
            k4n = k4 + s6 * (k1[1] + 2 * (k2[1] + k3[1]) + k4s[1])
            f4n = f4 + s6 * (k1[2] + 2 * (k2[2] + k3[2]) + k4s[2])
            rn = jnp.linalg.norm(x4n[1:])
            stop = (rn >= r_stop) | (rn <= r_capture)
            upd = alive
            return (jnp.where(upd, x4n, x4), jnp.where(upd, k4n, k4),
                    jnp.where(upd, f4n, f4), alive & ~stop), None

        (x4, k4, f4, alive), _ = lax.scan(
            step, (x4, k4, f4, jnp.asarray(True)), None, length=n_steps)

        g1 = metric.g(x4)
        fk = _einsum("mn,m,n->", g1, f4, k4)
        gff = _einsum("mn,m,n->", g1, f4, f4)
        # gauge fix f -> f - (f^t/k^t) k: purely spatial observable
        f_obs = f4[1:] - (f4[0] / k4[0]) * k4[1:]
        d_out = _unit(k4[1:])
        f_obs = f_obs - (_dot(f_obs, d_out)) * d_out
        return (_unit(f_obs), d_out, x4[1:],
                jnp.abs(fk), jnp.abs(gff - gff0), alive)

    f_obs, d_out, x_out, fk, gff, alive = jax.vmap(one)(x3, d3, f3)
    return f_obs, d_out, x_out, {
        "fk_drift": fk, "norm_drift": gff, "unfinished": alive}
