"""Multi-host helpers + deterministic shard-retry fault tolerance.

Single-process versions of the multi-host paths (jax.process_count() == 1
under the virtual CPU mesh); the retry logic is exercised with injected
faults -- the stand-in for the failure handling the reference
lacks entirely (SURVEY.md §5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from blackhole_geodesic_calculator_tpu.parallel import (
    gather_image, global_mesh, init_distributed, render_shards_with_retry,
)
from blackhole_geodesic_calculator_tpu.camera import Camera
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig
from blackhole_geodesic_calculator_tpu.render import RenderConfig
from blackhole_geodesic_calculator_tpu.render.renderer import render_rays
from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene


def test_init_distributed_single_host_noop():
    assert init_distributed(num_processes=1) is False


def test_global_mesh_covers_all_devices():
    mesh = global_mesh(sample_parallel=2)
    assert mesh.devices.size == len(jax.devices())
    assert dict(mesh.shape)["samples"] == 2


def test_gather_image_single_process_identity(rng):
    img = rng.random((8, 8, 3)).astype(np.float32)
    out = gather_image(img)
    np.testing.assert_array_equal(out, img)


def _tiny_scene():
    v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    sky = jnp.asarray(
        np.stack([u / 16.0, v / 8.0, np.ones_like(u, float)], -1),
        jnp.float32)
    scene = Scene(bh=BlackHole.make(mass=0.5), background=sky)
    cam = Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7))
    cfg = RenderConfig(width=16, height=16,
                       integrator=IntegratorConfig(n_steps=48, dt=0.2),
                       lam_max=60.0)
    return scene, cam, cfg


def test_render_shards_with_retry_deterministic():
    """A shard that fails transiently re-renders bit-identically, so the
    assembled image equals the fault-free render."""
    scene, cam, cfg = _tiny_scene()
    h, w = cfg.height, cfg.width
    ys, xs = np.mgrid[0:h, 0:w]
    n_shards = 4
    rows = h // n_shards

    fail_once = {"armed": True}

    def shard(i):
        if i == 2 and fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("injected preemption")
        sl = slice(i * rows, (i + 1) * rows)
        return np.asarray(render_rays(
            scene, cam, cfg,
            jnp.asarray(ys[sl].ravel()), jnp.asarray(xs[sl].ravel()),
        )).reshape(rows, w, 3)

    events = []
    parts = render_shards_with_retry(shard, n_shards, backoff_s=0.0,
                                     on_event=events.append)
    img = np.concatenate(parts, axis=0)
    assert len(events) == 1 and "shard 2" in events[0]

    ref = np.asarray(render_rays(
        scene, cam, cfg, jnp.asarray(ys.ravel()), jnp.asarray(xs.ravel()),
    )).reshape(h, w, 3)
    np.testing.assert_array_equal(img, ref)


def test_render_shards_with_retry_gives_up():
    def shard(i):
        raise RuntimeError("permanent fault")

    with pytest.raises(RuntimeError, match="permanent fault"):
        render_shards_with_retry(shard, 1, max_retries=1, backoff_s=0.0)


def test_render_with_failover_reconfigures_mesh(monkeypatch):
    """A persistently-failing mesh is rebuilt over the surviving device set
    (reported by the liveness probe) and the frame re-rendered -- pixel
    parity with a healthy render, events record the reconfiguration."""
    from blackhole_geodesic_calculator_tpu.parallel import (
        make_mesh, render_image_sharded, render_with_failover,
    )
    from blackhole_geodesic_calculator_tpu.parallel import render as prender

    scene, cam, cfg = _tiny_scene()
    healthy = np.asarray(render_image_sharded(
        scene, cam, cfg, mesh=make_mesh(jax.devices()[:4])))

    real = prender.render_image_sharded

    def flaky(scene, cam, cfg, mesh=None, key=None):
        if mesh is not None and mesh.devices.size == 8:
            raise RuntimeError("injected: device 7 lost")
        return real(scene, cam, cfg, mesh=mesh, key=key)

    monkeypatch.setattr(prender, "render_image_sharded", flaky)
    events = []
    img = np.asarray(render_with_failover(
        scene, cam, cfg, mesh=make_mesh(jax.devices()), backoff_s=0.0,
        on_event=events.append, probe=lambda: jax.devices()[:4]))
    assert any("reconfigured: 8 -> 4" in e for e in events), events
    np.testing.assert_allclose(img, healthy, atol=2e-6)


def test_render_with_failover_gives_up(monkeypatch):
    from blackhole_geodesic_calculator_tpu.parallel import (
        render_with_failover,
    )
    from blackhole_geodesic_calculator_tpu.parallel import render as prender

    scene, cam, cfg = _tiny_scene()

    def dead(*a, **k):
        raise RuntimeError("backend gone")

    monkeypatch.setattr(prender, "render_image_sharded", dead)
    with pytest.raises(RuntimeError, match="backend gone"):
        render_with_failover(scene, cam, cfg, max_retries=1,
                             backoff_s=0.0, probe=lambda: jax.devices())
