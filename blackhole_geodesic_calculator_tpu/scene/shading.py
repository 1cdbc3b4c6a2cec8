"""Branchless shading -- the reference's per-ray dispatch, vectorized.

The reference routes every ray through Python ifs: capture -> black, disk
crossing -> Gaussian-profile textured disk, object hit -> emission or
Lambert, miss -> equirect background, integrator error -> red debug pixel
(/root/reference/raytracer/RelativisticRenderEngine.py:239-246,
LimitedRelativisticRenderEngine.py:259-438).  Here each shader runs densely
over the batch and a status-mask select composes the final color -- no
divergence, fully differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import states
from ..ops.states import RayState
from .scene import Scene
from .texture import sample_bpy, sample_equirect, sphere_uv_bpy, safe_arccos

Array = jax.Array

# Reference rogue-ray color coding (LimitedRelativisticRenderEngine.py:311-314)
# numpy constants: importing the package must not initialize a backend
ERROR_COLOR = np.asarray([1.0, 0.0, 0.0], np.float32)
BLACK = np.zeros(3, np.float32)


def shade_background(scene: Scene, directions: Array) -> Array:
    """Equirect sky lookup; black when no sky is configured (reference
    background_hit fallback, RelativisticRenderEngine.py:376-378)."""
    if scene.background is None:
        return jnp.zeros(directions.shape[:-1] + (3,))
    d = directions / jnp.maximum(
        jnp.linalg.norm(directions, axis=-1, keepdims=True), 1e-20
    )
    return sample_equirect(scene.background, d)


def disk_redshift(x: Array, p: Array, E: Array, mass, spin=None,
                  orbit_dir=1.0) -> Array:
    """Combined gravitational + Doppler shift g = E_inf / E_emitted of a
    photon crossing the equatorial disk, for matter on Keplerian circular
    orbits (physics beyond the reference: its 'Add redshift' milestone is
    unchecked, reference README.md:217-220).

    Standard Kerr equatorial circular-orbit kinematics (geometrized units,
    Boyer-Lindquist radius; the BL and Kerr-Schild phi/t resummation leaves
    the Killing charges E = -p_t and L_z = p_phi invariant, so both come
    straight from the integrator state):

        Omega = s sqrt(M) / (r^(3/2) + s a sqrt(M)),       s = orbit_dir
        u^t   = (r^(3/2) + s a sqrt(M))
                / (r^(3/4) sqrt(r^(3/2) - 3 M sqrt(r) + s 2 a sqrt(M)))
        L_z   = x p_y - y p_x
        g     = E / (u^t (E - Omega L_z))

    Face-on limit (L_z -> 0, a = 0): g = sqrt(1 - 3M/r), the textbook
    result.  Inside the innermost circular photon orbit (u^t undefined) the
    factor is driven to 0 -- no stable emitter, rendered dark.
    """
    a = jnp.asarray(0.0 if spin is None else spin, jnp.float32)
    s = jnp.asarray(orbit_dir, jnp.float32)
    rho2 = x[..., 0] ** 2 + x[..., 1] ** 2
    r = jnp.sqrt(jnp.maximum(rho2 - a * a, 1e-12))  # BL radius at z = 0
    sqr = jnp.sqrt(r)
    sqM = jnp.sqrt(jnp.maximum(mass, 1e-20))
    omega = s * sqM / (r * sqr + s * a * sqM)
    denom2 = r * sqr - 3.0 * mass * sqr + s * 2.0 * a * sqM
    ut = (r * sqr + s * a * sqM) / (
        r ** 0.75 * jnp.sqrt(jnp.maximum(denom2, 1e-12)))
    lz = x[..., 0] * p[..., 1] - x[..., 1] * p[..., 0]
    e_emit = ut * jnp.maximum(E - omega * lz, 1e-12)
    g = E / jnp.maximum(e_emit, 1e-12)
    # no circular orbits inside the photon orbit: emit nothing
    return jnp.where(denom2 > 1e-12, g, 0.0)


def shade_disk(scene: Scene, hit_point: Array, p: Array | None = None,
               E: Array | None = None) -> Array:
    """Accretion-disk shader, exactly checkHitDisk's model
    (LimitedRelativisticRenderEngine.py:423-436):

        s         = (R - R_in)/(R_out - R_in)
        intensity = I * exp(-(s - mean)^2 / (2 stddev^2)) / sqrt(2 pi stddev)
        tex_x     = (phase + arccos(x/R) * sign(y)) / pi
        color     = tex(tex_x, s) * intensity
    """
    disk = scene.disk
    x, y = hit_point[..., 0], hit_point[..., 1]
    rr = jnp.sqrt(x * x + y * y)
    s = (rr - disk.r_in) / jnp.maximum(disk.r_out - disk.r_in, 1e-20)
    gauss = jnp.exp(-((s - disk.mean) ** 2) / (2.0 * disk.stddev**2))
    intensity = disk.intensity * gauss / jnp.sqrt(2.0 * jnp.pi * disk.stddev)
    sign_y = jnp.where(y >= 0, 1.0, -1.0)
    tex_x = (disk.phase + safe_arccos(x / jnp.maximum(rr, 1e-20)) * sign_y
             ) / jnp.pi
    rgb = sample_bpy(disk.texture, tex_x, s)
    out = rgb * intensity[..., None]
    if disk.beaming is not None and p is not None:
        g = disk_redshift(hit_point, p, E, scene.bh.mass, scene.bh.spin,
                          disk.orbit_dir if disk.orbit_dir is not None
                          else 1.0)
        out = out * (g ** disk.beaming)[..., None]
    return out


def _occluded(scene: Scene, origin: Array, direction: Array, dist: Array,
              eps: float = 1e-5) -> Array:
    """Any sphere or the horizon blocks the segment origin -> origin+dir*dist.

    The reference's shadow test is a Blender ray_cast from the hit point with
    a 1e-5 self-intersection offset (LimitedRelativisticRenderEngine.py:346,
    370); here it is an analytic occlusion test against the same geometry.
    """
    o = origin + direction * eps
    blocked = jnp.zeros(origin.shape[:-1], bool)

    def seg_hits_sphere(center, radius):
        oc = o - center
        b = jnp.sum(oc * direction, axis=-1)
        c = jnp.sum(oc * oc, axis=-1) - radius * radius
        disc = b * b - c
        # guarded sqrt: NaN-jacobian trap, see integrate._sphere_events
        sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
        t0 = -b - sq
        return (disc > 0) & (t0 > eps) & (t0 < dist)

    if scene.spheres is not None:
        k = scene.spheres.center.shape[0]
        for j in range(k):
            blocked |= seg_hits_sphere(
                scene.spheres.center[j], scene.spheres.radius[j]
            )
    # horizon sphere of the hole (located at origin of BH frame)
    rs = 2.0 * scene.bh.mass
    blocked |= seg_hits_sphere(jnp.zeros(3), rs)
    return blocked


def shade_sphere(scene: Scene, s: RayState) -> Array:
    """Surface shader: emission spherical-UV texture or Lambert with shadow
    rays, the reference normal_hit (LimitedRelativisticRenderEngine.py:338-380).
    Positions are in BH-centered coordinates (the renderer's working frame).
    """
    sph = scene.spheres
    obj = jnp.clip(s.hit_obj, 0, sph.center.shape[0] - 1)
    normal = s.hit_normal(sph.center)

    # --- emission branch: spherical UV from the object-local normal ------
    # Sample each of the K textures densely and select by object id: K is
    # small (a few moons), so K cheap bilinear gathers beat one giant
    # per-ray texture gather.
    ph, th = sphere_uv_bpy(normal)
    k_count = sph.texture.shape[0]
    emission_rgb = jnp.zeros(normal.shape[:-1] + (3,))
    for j in range(k_count):
        rgb_j = sample_bpy(sph.texture[j], ph, th)
        emission_rgb = jnp.where((obj == j)[..., None], rgb_j, emission_rgb)

    # --- Lambert branch (reference quirk kept: intensity enters twice) ----
    if scene.lights is not None:
        base = sph.albedo[obj] * scene.lights.intensity
        color = jnp.zeros(normal.shape[:-1] + (3,))
        for j in range(scene.lights.position.shape[0]):
            lp = scene.lights.position[j]
            lv = lp - s.x
            d2 = jnp.sum(lv * lv, axis=-1)
            ld = lv / jnp.maximum(jnp.sqrt(d2)[..., None], 1e-20)
            ndotl = jnp.sum(normal * ld, axis=-1)
            shadow = _occluded(scene, s.x, ld, jnp.sqrt(d2))
            vis = jnp.where(shadow, 0.0, 1.0)
            color = color + base * (
                scene.lights.intensity * vis * jnp.maximum(ndotl, 0.0) / d2
            )[..., None]
        lambert_rgb = color
    else:
        lambert_rgb = jnp.zeros(normal.shape[:-1] + (3,))

    w = sph.emission[obj][..., None]
    return w * emission_rgb + (1.0 - w) * lambert_rgb


def shade(scene: Scene, s: RayState, end_dir: Array) -> Array:
    """Compose the final per-ray RGB from the termination taxonomy.

    Reference dispatch (RelativisticRenderEngine.py:239-246 +
    LimitedRelativisticRenderEngine.py:283-335): disk > capture-black >
    error-red > object > background.
    """
    st = s.status
    color = shade_background(scene, end_dir)  # ESCAPED and BUDGET
    if scene.disk is not None:
        disk_rgb = shade_disk(scene, s.x, s.p, s.E)
        color = jnp.where((st == states.DISK)[..., None], disk_rgb, color)
    if scene.spheres is not None:
        obj_rgb = shade_sphere(scene, s)
        color = jnp.where((st == states.OBJECT)[..., None], obj_rgb, color)
    black = (st == states.CAPTURED) | (st == states.INSIDE_HORIZON)
    color = jnp.where(black[..., None], BLACK, color)
    color = jnp.where((st == states.ERROR)[..., None], ERROR_COLOR, color)
    return color
