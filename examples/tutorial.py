#!/usr/bin/env python
"""Executable tutorial: the reference's promised-but-unshipped
``Curvedpy_tutorial_and_examples.ipynb`` (/root/reference/README.md:248-250)
as a runnable script — every layer of the framework in one pass, small
enough to run on CPU in about a minute.

    python examples/tutorial.py [--outdir /tmp/bhgc_tutorial]

Sections:
  1. Trajectories   — integrate single geodesics, check light deflection
                      against the weak-field 4M/b law.
  2. Rendering      — whole-scene render_image (Gen-2/3) + a pixel gradient
                      with respect to the black-hole mass.
  3. Hybrid engine  — Gen-1 sphere-of-influence render, exact Schwarzschild
                      surrogate table, learned (MLP) surrogate.
  4. Sharding       — the same render SPMD over every visible device.
  5. Polarization   — Stokes I/Q/U of a polarized accretion disk.
"""

import argparse
import dataclasses
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/bhgc_tutorial")
    ap.add_argument("--size", type=int, default=96,
                    help="render resolution (96 keeps CPU runs ~1 min)")
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    t00 = time.perf_counter()

    import jax
    import jax.numpy as jnp

    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.io_ import tonemap, write_png
    from blackhole_geodesic_calculator_tpu.ops import (
        GeodesicEnv, IntegratorConfig, launch, trajectory, states,
    )
    from blackhole_geodesic_calculator_tpu.ops.integrate import final_direction
    from blackhole_geodesic_calculator_tpu.render import (
        LimitedConfig, RenderConfig, render_image, render_limited,
        render_stokes,
    )
    from blackhole_geodesic_calculator_tpu.scene import (
        BlackHole, Disk, Scene, Spheres,
    )

    print(f"# devices: {jax.devices()}")

    # ------------------------------------------------------------------
    # 1. Trajectories.  The physical core is `launch`: a batch of rays,
    # integrated to termination in one jitted program (the reference calls
    # scipy solve_ivp once per ray, RelativisticRenderEngine.py:293).
    # ------------------------------------------------------------------
    M = 0.5                       # geometrized units; horizon r_s = 2M = 1
    env = GeodesicEnv(mass=jnp.asarray(M), r_capture=jnp.asarray(2 * M),
                      r_escape=jnp.asarray(80.0), lam_max=jnp.asarray(400.0))
    cfg = IntegratorConfig(n_steps=2000, dt=0.1, dt_boost=1.0)

    # A fan of rays with impact parameters b = 6..14 M, moving +x (the
    # critical b_c = 3 sqrt(3) M ~ 5.2 M: anything below is captured):
    bs = jnp.linspace(6.0, 14.0, 9) * M
    x0 = jnp.stack([jnp.full_like(bs, -60.0), bs, jnp.zeros_like(bs)], -1)
    d0 = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), x0.shape)
    s = launch(env, x0, d0, cfg)
    ed = final_direction(env, s)
    defl = np.degrees(np.arctan2(np.asarray(ed[:, 1]), np.asarray(ed[:, 0])))
    print("\n[1] light deflection vs the weak-field law 4M/b:")
    for b, dfl in zip(np.asarray(bs), defl):
        print(f"    b = {b / M:5.2f} M   bent {abs(dfl):6.3f} deg "
              f"(weak-field {np.degrees(4 * M / b):6.3f} deg)")
    assert np.all(np.asarray(s.status) == states.ESCAPED)

    # Full trajectory polylines (the compat layer wraps this as the
    # reference's calc_trajectory) for e.g. plotting:
    xs, _, _ = trajectory(env, x0[:2], d0[:2],
                          dataclasses.replace(cfg, n_steps=400))
    print(f"    trajectory array: {xs.shape} (steps, rays, xyz)")

    # ------------------------------------------------------------------
    # 2. Whole-scene differentiable rendering (Gen-2/3).
    # ------------------------------------------------------------------
    H = Wd = args.size
    v = jnp.linspace(0.0, 1.0, 64)[:, None]
    u = jnp.linspace(0.0, 1.0, 128)[None, :]
    sky = jnp.stack([0.5 + 0.5 * jnp.sin(8 * jnp.pi * u) * jnp.sin(
        4 * jnp.pi * v) * jnp.ones_like(u * v),
        jnp.broadcast_to(v, (64, 128)), 0.6 * jnp.ones((64, 128))], -1)
    scene = Scene(
        bh=BlackHole.make(mass=M),
        background=sky,
        disk=Disk.make(r_in=2.2, r_out=6.0,
                       texture=jnp.ones((8, 8, 3)) * jnp.asarray(
                           [1.0, 0.62, 0.25]),
                       intensity=2.0, beaming=4.0),
        spheres=Spheres.make(center=[[0.0, 9.0, 2.0]], radius=[0.8],
                             texture=np.ones((1, 8, 8, 3), np.float32),
                             emission=[1.0], albedo=[[1, 1, 1]]),
    )
    cam = Camera.make(position=(0.0, -18.0, 3.5),
                      euler=(np.pi / 2 - 0.19, 0.0, 0.0), fov=(0.9, 0.9))
    rcfg = RenderConfig(width=Wd, height=H, samples=1,
                        integrator=IntegratorConfig(n_steps=400, dt=0.1),
                        lam_max=200.0)
    t0 = time.perf_counter()
    img = np.asarray(render_image(scene, cam, rcfg))
    path = os.path.join(args.outdir, "tutorial_disk.png")
    write_png(path, np.concatenate(
        [tonemap(img[..., :3]), img[..., 3:]], -1))
    print(f"\n[2] whole-scene render -> {path} "
          f"({time.perf_counter() - t0:.1f}s incl. compile)")

    # The render is ONE differentiable program: d(pixel)/d(mass) exists.
    def lum(mass):
        s2 = dataclasses.replace(
            scene, bh=dataclasses.replace(scene.bh, mass=mass))
        return jnp.mean(render_image(s2, cam, rcfg)[..., :3])

    g = float(jax.grad(lum)(jnp.asarray(M)))
    print(f"    d<image>/d(mass) = {g:+.4f}  (shadow grows with mass -> "
          f"mean luminosity falls)")

    # ------------------------------------------------------------------
    # 3. Gen-1 hybrid engine + surrogates.
    # ------------------------------------------------------------------
    lcfg = LimitedConfig(r_influence=10.0)
    sky_scene = Scene(bh=BlackHole.make(mass=M), background=sky)
    cam1 = Camera.make(position=(0.0, 0.0, 40.0), fov=(0.55, 0.55))
    rcfg1 = RenderConfig(width=Wd, height=H, samples=1,
                         integrator=IntegratorConfig(n_steps=300, dt=0.1),
                         lam_max=200.0)
    t0 = time.perf_counter()
    img_ode = np.asarray(render_limited(sky_scene, cam1, rcfg1, lcfg))
    img_tab = np.asarray(render_limited(
        sky_scene, cam1, rcfg1, dataclasses.replace(lcfg, approx=True)))
    err = np.abs(img_ode - img_tab)
    print(f"\n[3] Gen-1 hybrid: ODE vs exact surrogate table "
          f"mean|d| = {err.mean():.4f}, max|d| = {err.max():.2f} "
          f"(max sits on the photon ring, where neighbouring pixels "
          f"diverge; {time.perf_counter() - t0:.1f}s)")

    # The LEARNED surrogate (reference's planned 'Tensorflow model',
    # README.md:237) — here trained in seconds at toy scale; see
    # models/surrogate.py for the Kerr case that motivates it:
    from blackhole_geodesic_calculator_tpu.models.surrogate import (
        SurrogateConfig, evaluate_surrogate, train_surrogate,
    )

    scfg = SurrogateConfig(width=64, depth=3, r_influence=10.0,
                           n_steps=200, dt=0.1, lam_max=80.0,
                           backend="scan")
    t0 = time.perf_counter()
    sur, hist = train_surrogate(jax.random.PRNGKey(0), mass=M, spin=None,
                                cfg=scfg, steps=250, batch=512,
                                log_every=50)
    m = evaluate_surrogate(jax.random.PRNGKey(1), sur, scfg, n=4096)
    print(f"    learned surrogate: loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f} in {time.perf_counter() - t0:.1f}s; "
          f"capture acc {100 * m['capture_acc']:.1f}%, "
          f"median dir err {m['dir_err_median_rad']:.3f} rad")
    img_mlp = np.asarray(render_limited(
        sky_scene, cam1, rcfg1, dataclasses.replace(lcfg, approx=True),
        table=sur))
    path = os.path.join(args.outdir, "tutorial_limited_mlp.png")
    write_png(path, img_mlp)
    print(f"    MLP-surrogate render -> {path}")

    # ------------------------------------------------------------------
    # 4. Sharded rendering: the same program, SPMD over all devices.
    # On CPU run with XLA_FLAGS=--xla_force_host_platform_device_count=8
    # to see a virtual mesh; on several GPUs this is the production path.
    # ------------------------------------------------------------------
    from blackhole_geodesic_calculator_tpu.parallel import (
        make_mesh, render_image_sharded,
    )

    mesh = make_mesh()
    t0 = time.perf_counter()
    img_sh = np.asarray(render_image_sharded(scene, cam, rcfg, mesh))
    print(f"\n[4] sharded render over mesh {dict(mesh.shape)}: "
          f"max|d| vs single = {np.abs(img_sh - img).max():.2e} "
          f"({time.perf_counter() - t0:.1f}s)")

    # ------------------------------------------------------------------
    # 5. Polarization: Stokes I/Q/U of the beamed disk.
    # ------------------------------------------------------------------
    scene_pol = dataclasses.replace(
        scene, disk=dataclasses.replace(scene.disk, pol_frac=0.7))
    t0 = time.perf_counter()
    rgb, Q, U = [np.asarray(a) for a in render_stokes(scene_pol, cam, rcfg)]
    I = rgb.mean(-1)
    pf = np.where(I > 1e-4, np.hypot(Q, U) / np.maximum(I, 1e-20), 0.0)
    path = os.path.join(args.outdir, "tutorial_polfrac.png")
    write_png(path, np.clip(pf, 0, 1)[..., None].repeat(3, -1))
    print(f"\n[5] Stokes render: max pol fraction "
          f"{pf.max():.2f} -> {path} ({time.perf_counter() - t0:.1f}s)")

    print(f"\ntutorial done in {time.perf_counter() - t00:.1f}s; "
          f"images in {args.outdir}")


if __name__ == "__main__":
    main()
