"""Gen-1 "Limited" renderer: curved spacetime only inside a sphere of
influence, flat-space analytic ray casting outside.

Faithful batched reproduction of ``LimitedRelativisticRenderEngine``
(reference LimitedRelativisticRenderEngine.py:165-438): Blender's BVH
``scene.ray_cast`` becomes batched analytic sphere intersection, the
``"isBH"``-tagged sphere hand-off becomes a masked batched geodesic solve
with ``r_escape`` at the sphere boundary, and the whole pipeline --
flat cast -> geodesic hand-off -> disk test -> classify -> flat re-cast ->
shade -- is ONE branchless jitted program instead of per-pixel Python.

Reference behavior reproduced exactly (blackhole_hit :259-335):
  * disk crossing inside the sphere -> disk color * Gaussian intensity,
    background contribution black (:289-303);
  * horizon capture -> black (:308);
  * integrator error 'Outside' (budget exhausted inside the sphere) -> RED
    debug pixel (:311-314);
  * exit ray re-entering the BH sphere -> BLUE if end_dir_z < 0 else GREEN
    debug pixels (:324-330);
  * object hit after exit -> Lambert surface shading with shadow rays
    (normal_hit :338-380);
  * miss -> equirect background, or the ``test_output`` direction-gradient
    debug background (:390-396).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.pinhole import Camera, generate_rays, pixel_grid
from ..ops import states
from ..ops.geodesic import null_init
from ..ops.integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    integrate,
    final_direction,
)
from ..scene.scene import Scene
from ..scene.shading import shade_background, shade_disk, shade_sphere
from .renderer import RenderConfig

Array = jax.Array

# numpy constants: importing the package must not initialize a backend
RED = np.asarray([1.0, 0.0, 0.0], np.float32)
BLUE = np.asarray([0.0, 0.0, 1.0], np.float32)
GREEN = np.asarray([0.0, 1.0, 0.0], np.float32)
BLACK = np.zeros(3, np.float32)


@dataclasses.dataclass(frozen=True)
class LimitedConfig:
    """Gen-1 specific knobs (scene properties at
    LimitedRelativisticRenderEngine.py:486-506)."""

    r_influence: float = 20.0      # BH sphere radius ('ratio_obj_to_blackhole')
    exit_tolerance: float = 0.1    # exit shell thickness (:273-278)
    test_output: bool = False      # debug gradient background (:390-396)
    debug_colors: bool = True      # rogue-ray color coding (README.md:234)
    approx: bool = False           # surrogate table instead of the ODE (:60)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SurrogateTable:
    """Jittable scattering table -- the reference's ``approx`` fast path
    (``ApproxSchwarzschildGeodesic``, LimitedRelativisticRenderEngine.py:
    39-40,269; planned as 'Tensorflow model or interpolation',
    README.md:237).

    Exact up to interpolation by spherical symmetry: the exit state of a
    photon entering the influence sphere depends only on its impact
    parameter b, so a 1D table (built once with the real integrator)
    replaces every ODE solve with a gather + lerp + frame rotation.
    Reference semantics preserved: rebuilt when ``exit_tolerance`` or
    ``ratio_obj_to_blackhole`` change (:96-101), incompatible with the disk
    (:499 forces disk off -- the surrogate stores no trajectory to test
    against the z=0 plane).
    """

    b: Any         # (n,) impact parameters
    end_loc: Any   # (n, 3) canonical-frame exit positions
    end_dir: Any   # (n, 3) canonical-frame exit directions
    captured: Any  # (n,) bool

    @classmethod
    def build(cls, mass=0.5, r_influence=20.0, exit_tolerance=0.1,
              n=512, max_step=0.05, lam_max=200.0):
        """Run the real integrator once over the canonical geometry:
        enter at (-sqrt(R^2-b^2), b, 0) moving +x."""
        R = r_influence
        bs = jnp.linspace(0.0, R * 0.999, n)
        x0 = jnp.stack([-jnp.sqrt(jnp.maximum(R * R - bs * bs, 0.0)),
                        bs, jnp.zeros_like(bs)], -1)
        d0 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
        env = GeodesicEnv(
            mass=jnp.asarray(mass, jnp.float32),
            r_capture=jnp.asarray(2.0 * mass, jnp.float32),
            r_escape=jnp.asarray(R * (1.0 + exit_tolerance), jnp.float32),
            lam_max=jnp.asarray(lam_max, jnp.float32),
        )
        n_steps = int(np.ceil(lam_max / max_step))
        cfg = IntegratorConfig(n_steps=n_steps, dt=max_step, dt_boost=1.0)
        entry_in = x0 * (1.0 - 1e-4)
        p0, E0 = null_init(entry_in, d0, env.mass, None)
        s0 = states.init_state(entry_in, p0, E0)
        s = integrate(env, s0, cfg)
        ed = final_direction(env, s)
        captured = (s.status == states.CAPTURED) | (
            s.status == states.INSIDE_HORIZON) | (s.status == states.BUDGET)
        return cls(b=bs, end_loc=s.x, end_dir=ed, captured=captured)

    def trace(self, entry, d):
        """Batched surrogate trace in BH-centered coordinates.

        Returns (exit_loc, exit_dir, captured) -- the jittable twin of
        ``compat.ApproxSchwarzschildGeodesic.generatedRayTracer``.
        """
        dn = d / jnp.maximum(
            jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
        bvec = entry - jnp.sum(entry * dn, -1, keepdims=True) * dn
        b = jnp.linalg.norm(bvec, axis=-1)
        e1 = dn
        safe = (b > 1e-6)[..., None]
        ref = jnp.where(jnp.abs(dn[..., 0:1]) < 0.9,
                        jnp.asarray([1.0, 0.0, 0.0]),
                        jnp.asarray([0.0, 1.0, 0.0]))
        fallback = jnp.cross(dn, ref)
        fallback = fallback / jnp.maximum(
            jnp.linalg.norm(fallback, axis=-1, keepdims=True), 1e-20)
        e2 = jnp.where(safe, bvec / jnp.maximum(b[..., None], 1e-20),
                       fallback)
        e3 = jnp.cross(e1, e2)

        idx = jnp.clip(jnp.searchsorted(self.b, b), 1, self.b.shape[0] - 1)
        t = (b - self.b[idx - 1]) / jnp.maximum(
            self.b[idx] - self.b[idx - 1], 1e-20)
        t = jnp.clip(t, 0.0, 1.0)[..., None]
        el = self.end_loc[idx - 1] * (1 - t) + self.end_loc[idx] * t
        ed = self.end_dir[idx - 1] * (1 - t) + self.end_dir[idx] * t
        cap = self.captured[idx - 1] | self.captured[idx]

        def to_world(c):
            return (c[..., 0:1] * e1 + c[..., 1:2] * e2 + c[..., 2:3] * e3)

        exit_loc = to_world(el)
        exit_dir = to_world(ed)
        exit_dir = exit_dir / jnp.maximum(
            jnp.linalg.norm(exit_dir, axis=-1, keepdims=True), 1e-20)
        return exit_loc, exit_dir, cap


def _ray_spheres(o, d, centers, radii, t_min=1e-5):
    """Nearest forward ray-sphere hit; (t or inf, obj index or -1).
    The analytic replacement for Blender ``scene.ray_cast``
    (LimitedRelativisticRenderEngine.py:224,319)."""
    oc = o[..., None, :] - centers            # (..., K, 3)
    b = jnp.sum(oc * d[..., None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radii * radii
    disc = b * b - c
    sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > t_min, t0, t1)         # allow starts inside a sphere
    valid = (disc > 0) & (t > t_min)
    t = jnp.where(valid, t, jnp.inf)
    k = jnp.argmin(t, axis=-1)
    tb = jnp.min(t, axis=-1)
    return tb, jnp.where(jnp.isfinite(tb), k, -1).astype(jnp.int32)


def _flat_cast(scene: Scene, lcfg: LimitedConfig, o, d):
    """First hit among scene spheres and the BH influence sphere.
    Returns (t, obj, hit_bh_sphere) -- obj is -1 for none/BH-sphere."""
    t_bh, _ = _ray_spheres(
        o, d, scene.bh.loc[None, :],
        jnp.asarray([lcfg.r_influence], jnp.float32))
    if scene.spheres is not None:
        t_ob, obj = _ray_spheres(o, d, scene.spheres.center,
                                 scene.spheres.radius)
    else:
        t_ob = jnp.full_like(t_bh, jnp.inf)
        obj = jnp.full(t_bh.shape, -1, jnp.int32)
    bh_first = t_bh < t_ob
    t = jnp.where(bh_first, t_bh, t_ob)
    obj = jnp.where(bh_first, -1, obj)
    return t, obj, bh_first & jnp.isfinite(t_bh)


def _surface_state(x, obj):
    """RayState view of a flat-space surface hit for shade_sphere."""
    batch = obj.shape
    return states.RayState(
        x=x, p=jnp.zeros_like(x), E=jnp.ones(batch, x.dtype),
        lam=jnp.zeros(batch, x.dtype),
        status=jnp.full(batch, states.OBJECT, jnp.int32), hit_obj=obj)


def _background(scene, lcfg, d):
    """Equirect background or the reference's test_output direction
    gradient (LimitedRelativisticRenderEngine.py:390-396)."""
    if not lcfg.test_output:
        return shade_background(scene, d)
    dz, dy = d[..., 2], d[..., 1]
    neg = jnp.stack([jnp.zeros_like(dz), dz, dy], axis=-1)
    pos = jnp.stack([jnp.zeros_like(dz), jnp.zeros_like(dz), dz], axis=-1)
    return jnp.where((dz <= 0)[..., None], neg, pos)


def render_limited_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                        lcfg: LimitedConfig, ys, xs,
                        key=None, table: SurrogateTable | None = None
                        ) -> Array:
    o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, key)

    # --- stage 1: flat-space cast (reference :224-237) --------------------
    t1, obj1, enters_bh = _flat_cast(scene, lcfg, o, d)
    hit1 = jnp.isfinite(t1)
    x1 = o + d * jnp.where(hit1, t1, 0.0)[..., None]

    # --- stage 2: hand-off inside the sphere (:259-278) -------------------
    entry = x1 - scene.bh.loc
    entry_in = entry * (1.0 - 1e-4)
    if lcfg.approx:
        # Surrogate fast path (:269).  Reference semantics: disk forced off
        # when approx is on (:499) -- the surrogate keeps no trajectory.
        exit_rel, end_dir, cap_t = table.trace(entry_in, d)
        exit_loc = exit_rel + scene.bh.loc
        batch = cap_t.shape
        captured = cap_t & enters_bh
        outside_err = jnp.zeros(batch, bool)
        disk_hit = jnp.zeros(batch, bool)
        exited = enters_bh & ~cap_t
        disk_x = None
    else:
        disk = None
        if scene.disk is not None:
            disk = DiskGeom(r_in=scene.disk.r_in, r_out=scene.disk.r_out)
        if scene.bh.spin is None:
            r_cap = 2.0 * scene.bh.mass
        else:
            # Kerr outer horizon r_+ = M + sqrt(M^2 - a^2) < 2M; capturing
            # at 2M would swallow prograde photon-orbit rays (the a/M=0.9
            # prograde photon circle sits at ~1.56 M).
            from ..models.kerr import horizon_radius

            r_cap = horizon_radius(scene.bh.mass, scene.bh.spin)
        env = GeodesicEnv(
            mass=scene.bh.mass, spin=scene.bh.spin,
            r_capture=r_cap,
            r_escape=jnp.asarray(
                lcfg.r_influence * (1.0 + lcfg.exit_tolerance), jnp.float32),
            lam_max=jnp.asarray(cfg.lam_max, jnp.float32),
            disk=disk,
        )
        # Pull the entry point just inside so the escape test doesn't fire
        # immediately.  Rays that never enter the sphere are pre-terminated
        # (ESCAPED) so the integrator freezes them at step 0 instead of
        # tracing a discarded geodesic.
        p0, E0 = null_init(entry_in, d, env.mass, env.spin)
        s0 = states.init_state(entry_in, p0, E0)
        s0.status = jnp.where(enters_bh, s0.status,
                              jnp.full_like(s0.status, states.ESCAPED))
        inside = env.radius(entry_in) <= env.r_capture
        s0.status = jnp.where(inside, states.INSIDE_HORIZON, s0.status)
        s = integrate(env, s0, cfg.integrator)
        end_dir = final_direction(env, s)
        exit_loc = s.x + scene.bh.loc

        # --- stage 3: classify the geodesic outcome (:283-314) ------------
        captured = (s.status == states.CAPTURED) | (
            s.status == states.INSIDE_HORIZON)
        outside_err = (s.status == states.BUDGET) | (
            s.status == states.ERROR)
        disk_hit = s.status == states.DISK
        exited = s.status == states.ESCAPED
        disk_x = s.x

    # --- stage 4: flat re-cast from the exit point (:319-335) -------------
    t2, obj2, re_bh = _flat_cast(scene, lcfg, exit_loc, end_dir)
    hit2 = jnp.isfinite(t2) & (obj2 >= 0)
    x2 = exit_loc + end_dir * jnp.where(hit2, t2, 0.0)[..., None]

    # --- shading composition ----------------------------------------------
    # direct miss (no flat hit at all) -> background on the camera ray
    color = _background(scene, lcfg, d)
    if scene.spheres is not None:
        # direct object hit (:235)
        s_obj1 = _surface_state(x1 - scene.bh.loc, obj1)
        scene_bh = dataclasses.replace(
            scene, spheres=dataclasses.replace(
                scene.spheres, center=scene.spheres.center - scene.bh.loc))
        direct = shade_sphere(scene_bh, s_obj1)
        color = jnp.where((hit1 & (obj1 >= 0))[..., None], direct, color)

    # rays that entered the BH sphere:
    bh_color = _background(scene, lcfg, end_dir)       # exit -> miss (:335)
    if scene.spheres is not None:
        s_obj2 = _surface_state(x2 - scene.bh.loc, obj2)
        after = shade_sphere(scene_bh, s_obj2)
        bh_color = jnp.where(hit2[..., None], after, bh_color)
    if lcfg.debug_colors:
        rehit = re_bh & exited
        bh_color = jnp.where(
            (rehit & (end_dir[..., 2] < 0))[..., None], BLUE, bh_color)
        bh_color = jnp.where(
            (rehit & (end_dir[..., 2] >= 0))[..., None], GREEN, bh_color)
    if scene.disk is not None and disk_x is not None:
        # disk color * intensity, background term black (:289-303)
        disk_rgb = shade_disk(scene, disk_x)
        bh_color = jnp.where(disk_hit[..., None], disk_rgb, bh_color)
    bh_color = jnp.where(captured[..., None], BLACK, bh_color)
    if lcfg.debug_colors:
        bh_color = jnp.where(outside_err[..., None], RED, bh_color)
    else:
        bh_color = jnp.where(outside_err[..., None], BLACK, bh_color)

    return jnp.where(enters_bh[..., None], bh_color, color)


def _render_limited_impl(scene, cam, cfg, lcfg, key, table):
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1)
    if cfg.samples == 1:
        rgb = render_limited_rays(scene, cam, cfg, lcfg, ys, xs, None, table)
    else:
        def one(_, k):
            return None, render_limited_rays(scene, cam, cfg, lcfg, ys, xs,
                                             k, table)

        _, rgbs = jax.lax.scan(one, None, jax.random.split(key, cfg.samples))
        rgb = jnp.mean(rgbs, axis=0)
    full = jnp.ones((cfg.height, cfg.width, 4), rgb.dtype)
    return full.at[y0:y1, x0:x1, :3].set(rgb)


_render_limited_jit = jax.jit(_render_limited_impl,
                              static_argnames=("cfg", "lcfg"))


def render_limited(scene: Scene, cam: Camera, cfg: RenderConfig,
                   lcfg: LimitedConfig | None = None, key=None,
                   table: SurrogateTable | None = None) -> Array:
    """Full Gen-1 hybrid render -> (H, W, 4) RGBA.

    With ``lcfg.approx`` a ``SurrogateTable`` replaces the ODE solve; one is
    built on the fly if not supplied (reference reload-on-parameter-change
    semantics, LimitedRelativisticRenderEngine.py:96-101).
    """
    if lcfg is None:
        lcfg = LimitedConfig()
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    if lcfg.approx and table is None:
        if scene.bh.spin is not None:
            raise ValueError(
                "approx mode for a spinning hole needs a learned surrogate "
                "(the 1D table is exact only under spherical symmetry): "
                "train one with models.surrogate.train_surrogate and pass "
                "it as `table=`, or load an npz via SceneConfig."
                "surrogate_path")
        table = SurrogateTable.build(
            mass=float(scene.bh.mass), r_influence=lcfg.r_influence,
            exit_tolerance=lcfg.exit_tolerance)
    return _render_limited_jit(scene, cam, cfg, lcfg, key, table)
