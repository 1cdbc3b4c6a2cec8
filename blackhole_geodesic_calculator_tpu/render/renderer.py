"""The renderer: one jitted, differentiable program  render(scene, cam) -> image.

This is the reference's Gen-3 insight -- "precompute the whole camera ray
field as one batched geodesic solve, then shade"
(/root/reference/raytracer/RelativisticRenderEngineCamEdition.py:206-229) --
fused: camera ray generation, the batched geodesic integration with online
events, and shading are one XLA program with no pickle indirection, no
Python per-pixel loop (reference hot loop at
RelativisticRenderEngine.py:195-246), and full gradient flow from pixels to
every scene parameter.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import jax
import jax.numpy as jnp

from ..camera.pinhole import Camera, generate_rays, pixel_grid
from ..ops import states
from ..ops.integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    SphereGeom,
    final_direction,
    launch,
)
from ..scene.scene import Scene
from ..scene.shading import shade

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings -- the reference's PROPS scene properties
    (RelativisticRenderEngine.py:504-517) minus the differentiable ones,
    which live in Camera/Scene.

    * samples        -> eevee.taa_render_samples (:67)
    * seed           -> sampling_seed (:58, default 42 :509)
    * max affine len -> integration_depth/curve_end (:61, default 50 :508)
    * n_steps/dt     -> max_integration_step analogue (:57, default adaptive)
    * marks          -> mark_x/y_min/max debug crop (:106-118); -1 = off
    """

    width: int = 256
    height: int = 256
    samples: int = 1
    seed: int = 42
    integrator: IntegratorConfig = dataclasses.field(
        default_factory=IntegratorConfig
    )
    lam_max: float = 50.0
    r_escape: float = 0.0       # 0 -> auto: 2x camera distance + 20 r_s
    capture_factor: float = 1.0  # capture at r <= factor * r_s
    mark_x_min: int = -1
    mark_x_max: int = -1
    mark_y_min: int = -1
    mark_y_max: int = -1

    def crop(self):
        x0 = 0 if self.mark_x_min < 0 else self.mark_x_min
        x1 = self.width if self.mark_x_max < 0 else min(
            self.mark_x_max + 1, self.width)
        y0 = 0 if self.mark_y_min < 0 else self.mark_y_min
        y1 = self.height if self.mark_y_max < 0 else min(
            self.mark_y_max + 1, self.height)
        return x0, x1, y0, y1


def scene_env(scene: Scene, cfg: RenderConfig, cam: Camera) -> GeodesicEnv:
    """Build the integrator environment in BH-centered coordinates.

    The capture radius is the outer horizon: r_s = 2M for Schwarzschild,
    r_+ = M + sqrt(M^2 - a^2) for Kerr (models/kerr.horizon_radius) --
    capturing at 2M would wrongly swallow photons that orbit inside
    r < 2M around a spinning hole."""
    rs = 2.0 * scene.bh.mass
    if cfg.r_escape > 0:
        r_escape = jnp.asarray(cfg.r_escape, jnp.float32)
    else:
        cam_r = jnp.linalg.norm(cam.position - scene.bh.loc)
        r_escape = 2.0 * cam_r + 20.0 * rs
    disk = None
    if scene.disk is not None:
        disk = DiskGeom(r_in=scene.disk.r_in, r_out=scene.disk.r_out)
    spheres = None
    if scene.spheres is not None:
        spheres = SphereGeom(
            center=scene.spheres.center - scene.bh.loc,
            radius=scene.spheres.radius,
        )
    if scene.bh.spin is None:
        r_horizon = rs
    else:
        from ..models.kerr import horizon_radius

        r_horizon = horizon_radius(scene.bh.mass, scene.bh.spin)
    return GeodesicEnv(
        mass=scene.bh.mass,
        spin=scene.bh.spin,
        r_capture=cfg.capture_factor * r_horizon,
        r_escape=r_escape,
        lam_max=jnp.asarray(cfg.lam_max, jnp.float32),
        disk=disk,
        spheres=spheres,
    )


def _bh_frame(scene: Scene) -> Scene:
    """Shift world-frame positions into BH-centered coordinates (the
    reference's ``origin - self.bh_loc`` / ``loc - ob.location`` convention,
    RelativisticRenderEngine.py:278, LimitedRelativisticRenderEngine.py:265)."""
    spheres = scene.spheres
    if spheres is not None:
        spheres = dataclasses.replace(
            spheres, center=spheres.center - scene.bh.loc)
    lights = scene.lights
    if lights is not None:
        lights = dataclasses.replace(
            lights, position=lights.position - scene.bh.loc)
    return dataclasses.replace(scene, spheres=spheres, lights=lights)


def render_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                ys: Array, xs: Array, key: Array | None = None) -> Array:
    """Shade the rays through pixels (ys, xs) -- any shape, typically a
    (Hc, Wc) grid or a flat sharded (N,) batch.  Returns ys.shape + (3,).

    This is the whole reference pipeline -- camera ray, geodesic cast,
    dispatch, shade (RelativisticRenderEngine.py:218-250) -- as one pure
    batched function of pixel coordinates, which is what makes ray sharding
    trivial: shard (ys, xs), replicate (scene, cam), and XLA partitions the
    entire program with zero communication.
    """
    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, key)

    env = scene_env(scene, cfg, cam)
    scene_bh = _bh_frame(scene)
    o_rel = origin - scene.bh.loc

    s = launch(env, o_rel, d, cfg.integrator)
    end_dir = final_direction(env, s)
    return shade(scene_bh, s, end_dir)


def render_sample(scene: Scene, cam: Camera, cfg: RenderConfig,
                  key: Array | None) -> Array:
    """One jittered sample of the (cropped) image; returns (Hc, Wc, 3)."""
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1)
    return render_rays(scene, cam, cfg, ys, xs, key)


def _render_image_impl(scene: Scene, cam: Camera, cfg: RenderConfig,
                       key: Array) -> Array:
    if cfg.samples == 1:
        rgb = render_sample(scene, cam, cfg, None)
    else:
        def one(_, k):
            return None, render_sample(scene, cam, cfg, k)

        _, rgbs = jax.lax.scan(one, None, jax.random.split(key, cfg.samples))
        rgb = jnp.mean(rgbs, axis=0)

    x0, x1, y0, y1 = cfg.crop()
    full = jnp.ones((cfg.height, cfg.width, 4), rgb.dtype)
    full = full.at[y0:y1, x0:x1, :3].set(rgb)
    return full


_render_image_jit = jax.jit(_render_image_impl, static_argnames=("cfg",))


def render_image(scene: Scene, cam: Camera, cfg: RenderConfig,
                 key: Array | None = None) -> Array:
    """Full multisampled render -> (H, W, 4) RGBA in [0, 1]-ish HDR.

    Jitted as one program per (static) config -- on this stack un-jitted
    op-by-op dispatch costs ~ms per op, so the whole pipeline is always
    compiled even for interactive use.  Inside an outer jit/grad the inner
    jit is a no-op and the program inlines.

    Uncropped pixels are white with alpha 1, matching the reference's
    ones-initialized framebuffer (RelativisticRenderEngine.py:154).
    Sample jitter follows the reference convention: the multisample average
    over uniform +-half-pixel offsets (:227, :250).
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    return _render_image_jit(scene, cam, cfg, key)


def stokes_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                ys: Array, xs: Array):
    """Polarized render of the rays through pixels (ys, xs): returns
    (rgb, Q, U) with rgb of shape ys.shape + (3,) and Stokes Q, U of shape
    ys.shape -- the render-feature form of the reference's unchecked 'Add
    polarisation' milestone (reference README.md:217-220).

    Emission model (Disk.pol_frac): disk light is emitted with degree
    q sin^2(theta_em) (q = pol_frac, theta_em the angle between the photon
    and the disk normal -- the scattering-atmosphere orientation: zero
    face-on, maximal edge-on) and E-vector along the projection of the
    disk normal transverse to the photon.  The E-vector is then parallel-
    transported along the geodesic to the camera using the exact
    Schwarzschild plane decomposition (ops/polarization): the component
    along the conserved orbital-plane normal n = x cross p is carried
    unchanged, the in-plane transverse component stays in-plane -- no
    gravitational Faraday rotation in a spherically symmetric spacetime.
    For Kerr scenes the same decomposition is used as an a -> 0-exact
    approximation (frame-dragging Faraday rotation, a ~40x-cost per-pixel
    ODE, is available separately via polarization_map / ops.polarization's
    transport ODE).  Polarization angles are headless (mod pi), so the
    camera->scene integration direction is immaterial.

    Q/U convention: measured against the camera's (right, up) image axes,
    chi = atan2(f.up, f.right), Q = Ip cos 2chi, U = Ip sin 2chi with Ip =
    degree x disk-pixel luminance.  Sky/objects are unpolarized (Q = U = 0).
    """
    from ..camera.pinhole import euler_matrix
    from ..ops.polarization import _unit, plane_normal

    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, None)
    env = scene_env(scene, cfg, cam)
    scene_bh = _bh_frame(scene)
    o_rel = origin - scene.bh.loc

    s = launch(env, o_rel, d, cfg.integrator)
    end_dir = final_direction(env, s)
    rgb = shade(scene_bh, s, end_dir)

    zero = jnp.zeros(rgb.shape[:-1], rgb.dtype)
    if scene.disk is None or scene.disk.pol_frac is None:
        return rgb, zero, zero

    is_disk = s.status == states.DISK
    # photon direction AT the disk crossing (rays freeze at the event
    # point, so the final unit coordinate velocity is the disk-local one)
    k_d = end_dir
    # emitted E-vector: disk-normal projection transverse to the photon;
    # |f_raw| = sin(theta_em), reused for the emission degree
    f_raw = jnp.asarray([0.0, 0.0, 1.0]) - k_d * k_d[..., 2:3]
    sin2 = jnp.sum(f_raw * f_raw, axis=-1)
    p_eff = scene.disk.pol_frac * sin2
    f_hat = f_raw / jnp.maximum(jnp.sqrt(sin2), 1e-12)[..., None]

    # exact Schwarzschild transport: coefficients in the (n, e(k)) basis
    # are invariants of parallel transport along the planar geodesic
    n = plane_normal(o_rel, d)
    e_d = _unit(jnp.cross(k_d, n))
    alpha = jnp.sum(f_hat * n, axis=-1)
    beta = jnp.sum(f_hat * e_d, axis=-1)
    e_c = _unit(jnp.cross(d, n))
    f_obs = alpha[..., None] * n + beta[..., None] * e_c

    rot = euler_matrix(cam.euler)
    chi = jnp.arctan2(jnp.sum(f_obs * rot[:, 1], axis=-1),
                      jnp.sum(f_obs * rot[:, 0], axis=-1))
    lum = jnp.mean(rgb, axis=-1)
    ip = jnp.where(is_disk, p_eff * lum, 0.0)
    return rgb, ip * jnp.cos(2.0 * chi), ip * jnp.sin(2.0 * chi)


def render_stokes(scene: Scene, cam: Camera, cfg: RenderConfig):
    """Full-frame polarized render -> (rgb (H, W, 3), Q (H, W), U (H, W))
    over the crop window (pixel centers, deterministic).  See stokes_rays
    for the physical model and conventions."""
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1)
    return stokes_rays(scene, cam, cfg, ys, xs)


def _quantize_impl(scene: Scene, cam: Camera, cfg: RenderConfig,
                   key: Array, tonemap: bool, exposure: float) -> Array:
    img = _render_image_impl(scene, cam, cfg, key)
    rgb = img[..., :3]
    if tonemap:
        rgb = rgb * exposure
        rgb = rgb / (1.0 + rgb)          # Reinhard (io_.tonemap, on device)
    img = jnp.concatenate([rgb, img[..., 3:]], axis=-1)
    return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


_quantize_jit = jax.jit(
    _quantize_impl, static_argnames=("cfg", "tonemap", "exposure"))


def render_image_u8(scene: Scene, cam: Camera, cfg: RenderConfig,
                    key: Array | None = None, tonemap: bool = False,
                    exposure: float = 1.0) -> Array:
    """``render_image`` fused with ON-DEVICE tonemap + uint8 quantization
    -> (H, W, 4) uint8.  For animation pipelines the device->host frame
    transfer is part of every frame (a 1024^2 RGBA f32 frame is 16 MB);
    quantizing on device cuts the transfer 4x.  The PNG written
    from this array is bit-identical to quantizing the float render on the
    host (same clip/scale/round as io_.write_png)."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    return _quantize_jit(scene, cam, cfg, key, tonemap, float(exposure))


# Module-level jitted band/sample renderers for render_progressive: building
# fresh jax.jit wrappers per invocation would re-TRACE every call (the
# persistent cache only saves compiles), so warm progressive render loops
# would pay a full retrace per frame.
_progressive_rays_jit = jax.jit(render_rays, static_argnames=("cfg",))
_progressive_sample_jit = jax.jit(render_sample, static_argnames=("cfg",))


def render_progressive(scene: Scene, cam: Camera, cfg: RenderConfig,
                       key: Array | None = None,
                       row_bands: int = 16) -> Iterator[tuple[int, Array]]:
    """Generator yielding (update_index, partial RGBA) -- the
    progressive-update contract of the reference's render_scene/ray_trace
    generator (RelativisticRenderEngine.py:161-166,250,261).

    Granularity adapts to where the work is:

    * samples > 1: one yield per SAMPLE with the running average (each
      sample is one fused device program; finer slicing buys nothing).
    * samples == 1: one yield per ROW BAND (~``row_bands`` equal bands),
      honoring the reference's per-row progress for the default single-
      sample render -- one yield total would be no progress at all.  All
      bands share one compiled program (equal shapes; the last band is
      padded and trimmed).
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    x0, x1, y0, y1 = cfg.crop()

    if cfg.samples == 1:
        n_rows = y1 - y0
        band = max(1, -(-n_rows // max(1, min(row_bands, n_rows))))
        jit_rays = _progressive_rays_jit
        full = jnp.ones((cfg.height, cfg.width, 4), jnp.float32)
        i = 0
        yb = y0
        while yb < y1:
            take = min(band, y1 - yb)
            # fixed band shape so every band reuses one compilation; the
            # last band is SHIFTED UP to end exactly at the crop edge
            # (band <= n_rows by construction), so every rendered row is a
            # real crop row -- no ray is ever traced for a discarded
            # out-of-crop pixel
            yr = min(yb, y1 - band)
            ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1,
                                yr, yr + band)
            rgb = jit_rays(scene, cam, cfg, ys, xs, None)
            full = full.at[yb:yb + take, x0:x1, :3].set(
                rgb[yb - yr:yb - yr + take])
            yield i, full
            i += 1
            yb += take
        return

    jit_sample = _progressive_sample_jit
    keys = jax.random.split(key, cfg.samples)
    acc = None
    for i in range(cfg.samples):
        rgb = jit_sample(scene, cam, cfg=cfg, key=keys[i])
        acc = rgb if acc is None else acc + rgb
        full = jnp.ones((cfg.height, cfg.width, 4), rgb.dtype)
        full = full.at[y0:y1, x0:x1, :3].set(acc / (i + 1))
        yield i, full


def polarization_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                      ys: Array, xs: Array) -> Array:
    """Polarization rotation (radians) for the rays through pixels
    (ys, xs) -- any shape, typically a (Hc, Wc) grid or a flat sharded (N,)
    batch (parallel.polarization_map_sharded).  Returns ys.shape."""
    from ..ops.polarization import (
        _unit, plane_normal, polarization_rotation,
        transport_polarization_ode,
    )

    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, None)
    env = scene_env(scene, cfg, cam)
    o_rel = origin - scene.bh.loc

    if scene.bh.spin is None:
        s = launch(env, o_rel, d, cfg.integrator)
        d1 = final_direction(env, s)
        ang = polarization_rotation(o_rel, d, d1)
        escaped = (s.status == states.ESCAPED) | (s.status == states.BUDGET)
        return jnp.where(escaped, ang, jnp.nan)

    # Kerr: parallel-transport ODE (frame dragging adds gravitational
    # Faraday rotation the closed form cannot capture).  KS metrics take
    # the analytic directional-Christoffel contraction
    # (ops/polarization.ks_directional_christoffel, ~3x the generic AD
    # path), but this is still ~10x the flops of the Hamiltonian render
    # path -- a science instrument, use modest resolutions.  Observable: rotation of the transported in-plane basis
    # vector relative to the escape-frame in-plane basis.
    from ..models import kerr_ks_metric

    metric = kerr_ks_metric(scene.bh.mass, scene.bh.spin)
    shape = ys.shape
    x3 = o_rel.reshape(-1, 3)
    d3 = d.reshape(-1, 3)
    n = plane_normal(x3, d3)
    f0 = _unit(jnp.cross(d3, n))            # in-plane basis at launch
    it = cfg.integrator
    f_obs, d1, x1, diag = transport_polarization_ode(
        metric, x3, d3, f0,
        n_steps=it.n_steps, dt=it.dt,
        r_stop=float(cfg.r_escape) if cfg.r_escape > 0 else 70.0,
        dt_boost=max(it.dt_boost, 1.0),
        r_ref=it.dt_boost_r_ref or 1.6)
    e_in1 = _unit(jnp.cross(d1, n))
    ang = jnp.arctan2(jnp.sum(f_obs * n, -1), jnp.sum(f_obs * e_in1, -1))
    escaped = (jnp.linalg.norm(x1, axis=-1)
               >= 0.99 * (float(cfg.r_escape) if cfg.r_escape > 0 else 70.0))
    return jnp.where(escaped, ang, jnp.nan).reshape(shape)


# Above this many Kerr pixels on one device, warn and point at the sharded
# entry: the per-pixel AD-Christoffel transport ODE is ~40x the flops of
# the render path, and a quietly-launched 1024^2 map would run for hours.
_KERR_POLARIZATION_WARN_PIXELS = 256 * 256


def polarization_map(scene: Scene, cam: Camera, cfg: RenderConfig):
    """Per-pixel polarization rotation map (radians) over the (cropped)
    image -- the reference's unchecked 'Add polarisation' milestone
    (reference README.md:217-220), exact closed form for Schwarzschild
    (ops/polarization.py: no gravitational Faraday rotation in a
    spherically symmetric spacetime, so the observable is the geometric
    rotation of the in-plane basis); for Kerr the parallel-transport ODE is
    integrated per pixel and the map measures the TOTAL rotation including
    frame dragging.  Captured/error pixels get NaN.

    For large Kerr maps use ``parallel.polarization_map_sharded`` (same
    result, rays sharded over the device mesh)."""
    x0c, x1c, y0c, y1c = cfg.crop()
    if (scene.bh.spin is not None
            and (x1c - x0c) * (y1c - y0c) > _KERR_POLARIZATION_WARN_PIXELS):
        import warnings

        warnings.warn(
            f"Kerr polarization map over {(x1c - x0c) * (y1c - y0c)} pixels "
            "on one device: the parallel-transport ODE is ~40x the render "
            "path's flops. Use parallel.polarization_map_sharded or a "
            "mark_* crop window.", stacklevel=2)
    ys, xs = pixel_grid(cfg.width, cfg.height, x0c, x1c, y0c, y1c)
    return polarization_rays(scene, cam, cfg, ys, xs)
