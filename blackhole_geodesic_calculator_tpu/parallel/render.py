"""Multi-device sharded rendering.

Replaces the reference's absent parallel runtime (SURVEY.md §2.2: an
abandoned ``mp.Pool`` block at
/root/reference/raytracer/RelativisticRenderEngine.py:210-216 and per-frame
cluster job farming) with SPMD over a ``jax.sharding.Mesh`` via
``shard_map`` -- explicit per-device programs with explicit collectives,
which (unlike sharding-annotation auto-partitioning) also composes with the
Pallas integrator kernel, since each device simply runs its local
``pallas_call``:

* the flat pixel batch is sharded over the ``rays`` mesh axis;
* multisample jitters are sharded over the ``samples`` axis and reduced
  with one ``pmean``;
* scene/camera parameters are replicated (a few KB);
* a **load-balancing shuffle**: cost per ray is wildly nonuniform (shadow
  rays capture in a few steps, photon-sphere grazers need thousands --
  reference ``nr_points_curve=10000``), so pixels are dealt round-robin
  across shards before the solve and unpermuted after.  Contiguous row
  blocks would make the shard containing the photon ring the straggler.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..camera.pinhole import Camera
from ..render.renderer import RenderConfig, render_rays
from ..scene.scene import Scene
from .mesh import RAY_AXIS, SAMPLE_AXIS, make_mesh, put_global

Array = jax.Array


def _flat_pixels(cfg: RenderConfig, n_shards: int):
    """Flattened (ys, xs) of the crop window, dealt round-robin over shards
    and padded so every shard gets the same count.  Returns (ys, xs, perm,
    n_valid) -- ``perm[i]`` is the flat crop-pixel index that ray slot i
    serves; framebuffer assembly inverts the deal by LAYOUT (_undeal_cm:
    a channel-major reshape/transpose/slice) rather than by an
    arbitrary-index scatter or gather."""
    return _flat_pixels_cached(cfg, n_shards)


@functools.lru_cache(maxsize=64)
def _flat_pixels_cached(cfg: RenderConfig, n_shards: int):
    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0
    n = hc * wc
    pad = (-n) % n_shards
    total = n + pad
    # Round-robin deal: slot (s, j) -> pixel j * n_shards + s.  Neighboring
    # pixels (similar geodesic cost) land on different shards.
    slot = jnp.arange(total)
    per = total // n_shards
    perm = (slot % per) * n_shards + slot // per
    perm = jnp.where(perm < n, perm, 0)  # padding slots re-trace pixel 0
    ys = y0 + perm // wc
    xs = x0 + perm % wc
    return ys, xs, perm, n


def _undeal_cm(flat_cm, n_shards, n):
    """Invert the round-robin deal by layout instead of indexing:
    (C, total) slot-ordered channels -> (C, n) pixel-ordered.

    The deal maps slot s*per + j -> pixel j*n_shards + s
    (_flat_pixels_cached), so pixel order is the (per, n_shards) transpose
    of the (n_shards, per) slot view; padding slots land at positions >= n
    and are sliced off.  With one shard the deal is the identity.  The
    transpose is a regular copy, and the assembly works channel-major so
    the HUGE axis stays minor-most through every reshape/transpose.  (Both
    choices were made for an earlier accelerator's layout and have not been
    measured against the plain index forms on the GPU yet.)
    """
    if n_shards == 1:
        return flat_cm[..., :n]
    C, total = flat_cm.shape
    per = total // n_shards
    t = flat_cm.reshape(C, n_shards, per)
    return jnp.swapaxes(t, 1, 2).reshape(C, total)[:, :n]


@functools.lru_cache(maxsize=64)
def _sharded_pixels(mesh: Mesh, cfg: RenderConfig):
    """Device-resident sharded pixel plumbing, cached per (mesh, cfg):
    (ys, xs) sharded over the ray axis.  The grids are deterministic
    functions of the static config, so warm render/train loops skip the
    per-call host->device puts and the index math entirely -- without this,
    dispatch of the ~ms-scale sharded render is serialized behind ~10 host
    ops per frame."""
    n_ray = mesh.shape[RAY_AXIS]
    ys, xs, _, _ = _flat_pixels(cfg, n_ray)
    shard = NamedSharding(mesh, P(RAY_AXIS))
    return put_global(ys, shard), put_global(xs, shard)


@functools.lru_cache(maxsize=64)
def _sharded_render_fn(mesh: Mesh, cfg: RenderConfig, multisample: bool,
                       force_general: bool = False):
    """Build the shard_map'd per-device render program WITH the framebuffer
    assembly fused in (one jit, one dispatch per frame, so no host round
    trip sits between render and assembly).  The replicated
    output sharding makes XLA all-gather the ray shards into the full frame
    on every device/host (the multi-host counterpart of the reference's
    update_result flush, RelativisticRenderEngine.py:162).

    DEGENERATE-MESH BYPASS: on a 1x1 mesh (one chip, no multisample axis)
    the round-robin deal is the identity and there are no collectives, so
    the whole flat-batch plumbing -- deal, channel-major assembly,
    unpermute -- is pure overhead charged against the multi-host scaling
    budget before a single collective exists.  That case renders the 2D pixel
    grid directly (the exact unsharded program, bit-identical pixels) under
    the same jit/output contract."""
    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0

    if (mesh.shape[RAY_AXIS] == 1 and mesh.shape[SAMPLE_AXIS] == 1
            and not multisample and not force_general):
        from ..render.renderer import _render_image_impl

        def direct(scene, cam, keys, ys, xs):
            del keys, ys, xs
            # samples == 1 (multisample False): the key is never consumed
            return _render_image_impl(
                scene, cam, cfg, jax.random.PRNGKey(cfg.seed))

        return jax.jit(direct, out_shardings=NamedSharding(mesh, P()))

    # Per-shard ray batches beyond ~1M rays are processed in lax.map
    # chunks, which bounds every shading temp (texture gathers, selects)
    # to CHUNK rays with no change in values (the integrator's cost
    # reorder happens per call, i.e. per chunk).  The split was sized for
    # an earlier accelerator's tiled layout; its cost on the GPU has not
    # been measured yet.
    CHUNK = 1 << 20

    def _render_chunked(scene, cam, ys, xs):
        n_loc = ys.shape[0]
        if n_loc <= CHUNK:
            return render_rays(scene, cam, cfg, ys, xs, None)
        # lax.map over the divisible prefix + one call on the tail, so a
        # non-multiple ray count (4096x2160, odd meshes) still has every
        # shading temp bounded by CHUNK instead of falling back to the
        # one-shot form.  Values are unchanged: render_rays is pure per
        # ray and the integrator's cost reorder is unpermuted inside each
        # call.
        n_full = (n_loc // CHUNK) * CHUNK
        rgb = jax.lax.map(
            lambda c: render_rays(scene, cam, cfg, c[0], c[1], None),
            (ys[:n_full].reshape(-1, CHUNK), xs[:n_full].reshape(-1, CHUNK)))
        rgb = rgb.reshape(n_full, 3)
        if n_full < n_loc:
            tail = render_rays(scene, cam, cfg, ys[n_full:], xs[n_full:],
                               None)
            rgb = jnp.concatenate([rgb, tail])
        return rgb

    def local(scene, cam, keys, ys, xs):
        if not multisample:
            return _render_chunked(scene, cam, ys, xs)
        # multisample keeps the one-shot form: the jitter stream is
        # shape-dependent (camera.generate_rays), so chunking would change
        # sample values; huge deterministic previews are the chunked case
        rgb = jnp.mean(
            jax.vmap(lambda k: render_rays(scene, cam, cfg, ys, xs, k))(keys),
            axis=0,
        )
        return jax.lax.pmean(rgb, SAMPLE_AXIS)

    local_sm = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(SAMPLE_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )

    n_ray = mesh.shape[RAY_AXIS]

    def full(scene, cam, keys, ys, xs):
        rgb = local_sm(scene, cam, keys, ys, xs)
        # channel-major assembly (see _undeal_cm), (H, W, 4) only at the end
        img = _undeal_cm(rgb.T, n_ray, hc * wc).reshape(3, hc, wc)
        frame = jnp.ones((4, cfg.height, cfg.width), rgb.dtype)
        frame = frame.at[:3, y0:y1, x0:x1].set(img)
        return jnp.transpose(frame, (1, 2, 0))

    return jax.jit(full, out_shardings=NamedSharding(mesh, P()))


def render_image_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    mesh: Mesh | None = None,
    key: Array | None = None,
    _force_general: bool = False,
) -> Array:
    """Full multisampled render on a device mesh -> (H, W, 4) RGBA.

    Pixel-exact with the single-device ``render_image`` for samples == 1
    (same pixel-center rays, same integrator); multisample jitters differ
    only in RNG fan-out order.

    ``_force_general`` disables the degenerate-mesh bypass so the full
    shard_map + deal + assembly machinery runs even on a 1x1 mesh -- for
    benchmarking/parity-gating that machinery on single-chip hardware
    (bench.py), never needed by users.
    """
    if mesh is None:
        mesh = make_mesh()
    n_ray = mesh.shape[RAY_AXIS]
    n_smp = mesh.shape[SAMPLE_AXIS]
    if cfg.samples % n_smp != 0:
        raise ValueError(
            f"samples={cfg.samples} must be a multiple of the mesh "
            f"'{SAMPLE_AXIS}' extent {n_smp}"
        )

    ys, xs = _sharded_pixels(mesh, cfg)
    repl = NamedSharding(mesh, P())
    scene = put_global(scene, repl)
    cam = put_global(cam, repl)

    multisample = not (cfg.samples == 1 and key is None)
    if multisample:
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        keys = put_global(
            jax.random.split(key, cfg.samples),
            NamedSharding(mesh, P(SAMPLE_AXIS)),
        )
    else:
        # dummy replicated-shape keys array (unused)
        keys = put_global(
            jnp.zeros((n_smp, 2), jnp.uint32),
            NamedSharding(mesh, P(SAMPLE_AXIS)),
        )

    return _sharded_render_fn(mesh, cfg, multisample, _force_general)(
        scene, cam, keys, ys, xs)


def render_stokes_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    mesh: Mesh | None = None,
    _force_general: bool = False,
):
    """Polarized (Stokes) render sharded over the ``rays`` mesh axis -- the
    multi-device form of ``render.render_stokes``, sharing its physical
    model and conventions (renderer.stokes_rays) and this module's
    round-robin load-balancing deal.  Same rays and integrator as the
    single-device path (deterministic pixel-center rays, no jitter); agrees
    to f32 compilation noise -- per-shard fusion differences can amplify on
    near-critical rays.  Returns
    (rgb (Hc, Wc, 3), Q (Hc, Wc), U (Hc, Wc)) over the crop window,
    replicated on every device/host."""
    if mesh is None:
        mesh = make_mesh()
    ys, xs = _sharded_pixels(mesh, cfg)
    repl = NamedSharding(mesh, P())
    return _sharded_stokes_fn(mesh, cfg, _force_general)(
        put_global(scene, repl), put_global(cam, repl), ys, xs)


@functools.lru_cache(maxsize=64)
def _sharded_stokes_fn(mesh: Mesh, cfg: RenderConfig,
                       force_general: bool = False):
    """Cached fused shard_map + gather-back assembly for the Stokes render
    (one jit, one dispatch; see _sharded_render_fn)."""
    from ..render.renderer import render_stokes, stokes_rays

    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0

    if (mesh.shape[RAY_AXIS] == 1 and mesh.shape[SAMPLE_AXIS] == 1
            and not force_general):
        # degenerate mesh: render the grid directly (see _sharded_render_fn)
        repl0 = NamedSharding(mesh, P())

        def direct(scene, cam, ys, xs):
            del ys, xs
            return render_stokes(scene, cam, cfg)

        return jax.jit(direct, out_shardings=(repl0, repl0, repl0))
    local_sm = shard_map(
        lambda sc, c, ys_, xs_: stokes_rays(sc, c, cfg, ys_, xs_),
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        check_vma=False,
    )

    n_ray = mesh.shape[RAY_AXIS]

    def full(scene, cam, ys, xs):
        rgb, q, u = local_sm(scene, cam, ys, xs)
        n = hc * wc
        img = _undeal_cm(rgb.T, n_ray, n).reshape(3, hc, wc)
        return (jnp.transpose(img, (1, 2, 0)),
                _undeal_cm(q[None], n_ray, n).reshape(hc, wc),
                _undeal_cm(u[None], n_ray, n).reshape(hc, wc))

    repl = NamedSharding(mesh, P())
    return jax.jit(full, out_shardings=(repl, repl, repl))


def polarization_map_sharded(
    scene: Scene,
    cam: Camera,
    cfg: RenderConfig,
    mesh: Mesh | None = None,
) -> Array:
    """Polarization rotation map sharded over the ``rays`` mesh axis --
    the multi-device form of ``render.polarization_map``, and the intended
    entry point for large KERR maps (the per-pixel parallel-transport ODE
    is ~40x the render path's flops; see renderer.polarization_rays).
    Pixel-exact with the single-device map (deterministic, no jitter).
    Returns (Hc, Wc) with NaN at captured/error pixels."""
    if mesh is None:
        mesh = make_mesh()
    ys, xs = _sharded_pixels(mesh, cfg)
    repl = NamedSharding(mesh, P())
    return _sharded_polarization_fn(mesh, cfg)(
        put_global(scene, repl), put_global(cam, repl), ys, xs)


@functools.lru_cache(maxsize=64)
def _sharded_polarization_fn(mesh: Mesh, cfg: RenderConfig):
    """Cached fused shard_map + gather-back assembly for the polarization
    map (one jit, one dispatch; see _sharded_render_fn)."""
    from ..camera.pinhole import pixel_grid
    from ..render.renderer import polarization_rays

    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0

    if mesh.shape[RAY_AXIS] == 1 and mesh.shape[SAMPLE_AXIS] == 1:
        # degenerate mesh: render the grid directly (see _sharded_render_fn)
        def direct(scene, cam, ys, xs):
            del ys, xs
            gys, gxs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1)
            return polarization_rays(scene, cam, cfg, gys, gxs)

        return jax.jit(direct, out_shardings=NamedSharding(mesh, P()))
    local_sm = shard_map(
        lambda sc, c, ys_, xs_: polarization_rays(sc, c, cfg, ys_, xs_),
        mesh=mesh,
        in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )

    n_ray = mesh.shape[RAY_AXIS]

    def full(scene, cam, ys, xs):
        # NaN masking lives in ang itself
        return _undeal_cm(local_sm(scene, cam, ys, xs)[None], n_ray,
                          hc * wc).reshape(hc, wc)

    return jax.jit(full, out_shardings=NamedSharding(mesh, P()))
