#!/usr/bin/env python
"""Inverse rendering: recover black-hole mass + camera orbit pose from
rendered frames (BASELINE config 4 as a runnable showcase).

The reference's flagship artifact is a 1024² × 100-frame × 5-spp orbit
animation (/root/reference/README.md:8-9) -- forward-only.  This framework
can run that camera BACKWARD: render N target frames of an orbit with a
known (mass, phase, roll), then recover all three from pixels alone by
gradient descent THROUGH the geodesic integrator (the RK4 kernel with its
XLA segment adjoint on a GPU, the remat XLA scan on CPU), sharded over whatever
device mesh is available.

Two estimator tools make the fit converge to sub-percent where naive pixel
MSE stalls (measured in tests/test_parallel.py::
test_trainer_orbit_fit_camera_and_mass):

* ``mask_critical=0.25`` drops photon-sphere-winding rays whose pointwise
  AD derivatives oscillate (the loss is micro-rough there);
* ``reuse_keys=True`` (common random numbers) renders fit samples with the
  SAME jitter keys as the targets, making the loss a deterministic function
  of the parameters with an exact zero at the truth.

Writes a JSON convergence table (per-step losses, recovered vs true
parameters) to --outdir and prints a summary.  CPU-runnable in minutes at
the default size; CI runs a reduced smoke
(tests/test_io_cli.py::test_fit_orbit_example_smoke).

Usage:
    python examples/fit_orbit.py                    # ~1-2 min on CPU
    python examples/fit_orbit.py --size 96 --epochs 80   # tighter fit
"""

import argparse
import dataclasses
import json
import os
import sys
import time

# runnable as `python examples/fit_orbit.py` without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48,
                    help="frame width (height = 3/4 width)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--n-steps", type=int, default=150,
                    help="integrator steps per ray")
    ap.add_argument("--mass-true", type=float, default=0.5)
    ap.add_argument("--mass-init", type=float, default=0.38)
    ap.add_argument("--dphi-init", type=float, default=0.07,
                    help="initial orbit-phase error (0.07 rad = 0.7 scene "
                    "units of camera position error on the r=10 orbit)")
    ap.add_argument("--de2-init", type=float, default=-0.06,
                    help="initial camera roll error (rad)")
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig
    from blackhole_geodesic_calculator_tpu.parallel import (
        Trainer, make_mesh, render_image_sharded,
    )
    from blackhole_geodesic_calculator_tpu.render import RenderConfig
    from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene

    w, h = args.size, (args.size * 3) // 4
    cfg = RenderConfig(
        width=w, height=h, samples=args.samples,
        integrator=IntegratorConfig(n_steps=args.n_steps, dt=0.15,
                                    dt_boost=16.0, dt_boost_r_ref=1.6,
                                    dt_power=1.5),
        lam_max=80.0,
    )

    # Smooth procedural sky: the fit reads pose from how the hole lenses
    # the gradient.  SMOOTH matters -- a high-frequency texture (stars,
    # checkers) aliases at small frame sizes and turns the pixel-MSE
    # gradients into noise; with a real HDRI, pre-blur or fit at higher
    # resolution.
    v = np.linspace(0.0, 1.0, 16)[:, None]
    u = np.linspace(0.0, 1.0, 32, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    sky = jnp.asarray(np.stack(
        [np.broadcast_to(uc, (16, 32)),
         np.broadcast_to(v, (16, 32)),
         0.5 * np.ones((16, 32))], -1), jnp.float32)

    r_orbit = 10.0
    phases = [2.1 * f for f in range(args.frames)]

    def orbit_cam(phase, dphi, de2):
        """Camera on an r=10 orbit; position AND look-at euler derive from
        the same learned phase offset, so the fit is true pose recovery."""
        ph = jnp.asarray(phase, jnp.float32) + dphi
        pos = jnp.stack([r_orbit * jnp.sin(ph), jnp.asarray(0.0),
                         r_orbit * jnp.cos(ph)])
        return dataclasses.replace(
            Camera.make(position=(0.0, 0.0, 0.0), fov=(0.8, 0.8)),
            position=pos, euler=jnp.stack([jnp.asarray(0.0), ph, de2]))

    mesh = make_mesh()
    key0 = jax.random.PRNGKey(cfg.seed)
    true_scene = Scene(bh=BlackHole.make(mass=args.mass_true),
                       background=sky)

    print(f"rendering {args.frames} target frames "
          f"({w}x{h}x{args.samples}spp, mass={args.mass_true}) on "
          f"mesh={dict(mesh.shape)} ...")
    t0 = time.perf_counter()
    zero = jnp.asarray(0.0)
    targets = [
        render_image_sharded(true_scene, orbit_cam(ph, zero, zero),
                             cfg, mesh, key=jax.random.fold_in(key0, f)
                             )[..., :3]
        for f, ph in enumerate(phases)
    ]
    jax.block_until_ready(targets)
    print(f"  targets in {time.perf_counter() - t0:.1f}s")

    def frame_param_fn(p, phase):
        scene = Scene(bh=BlackHole.make(mass=0.0), background=sky)
        scene = dataclasses.replace(
            scene, bh=dataclasses.replace(scene.bh, mass=p["mass"]))
        return scene, orbit_cam(phase, p["dphi"], p["de2"])

    n_total = args.epochs * args.frames
    sched = optax.cosine_decay_schedule(2e-2, n_total, 0.05)
    tr = Trainer(cfg=cfg, param_fn=lambda p: (None, None),
                 frame_param_fn=frame_param_fn,
                 optimizer=optax.chain(optax.clip_by_global_norm(0.5),
                                       optax.adam(sched)),
                 mesh=mesh, mask_critical=0.25)
    params0 = {"mass": jnp.asarray(args.mass_init),
               "dphi": jnp.asarray(args.dphi_init),
               "de2": jnp.asarray(args.de2_init)}

    print(f"fitting mass+phase+roll for {args.epochs} epochs x "
          f"{args.frames} frames (CRN, mask_critical=0.25) ...")
    t0 = time.perf_counter()
    params, losses = tr.fit_frames(
        params0, targets, phases, n_epochs=args.epochs, key=key0,
        reuse_keys=True, log_every=max(1, n_total // 10))
    fit_s = time.perf_counter() - t0

    mass = float(np.asarray(params["mass"]))
    dphi = float(np.asarray(params["dphi"]))
    de2 = float(np.asarray(params["de2"]))
    mass_rel_err = abs(mass - args.mass_true) / args.mass_true
    result = {
        "config": {"size": [w, h], "samples": args.samples,
                   "frames": args.frames, "epochs": args.epochs,
                   "n_steps": args.n_steps,
                   "mesh": {k: int(v) for k, v in mesh.shape.items()}},
        "true": {"mass": args.mass_true, "dphi": 0.0, "de2": 0.0},
        "init": {"mass": args.mass_init, "dphi": args.dphi_init,
                 "de2": args.de2_init},
        "recovered": {"mass": mass, "dphi": dphi, "de2": de2},
        "errors": {"mass_rel": mass_rel_err, "dphi_abs": abs(dphi),
                   "de2_abs": abs(de2)},
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_min": min(losses), "losses": losses,
        "fit_seconds": fit_s,
    }
    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, "fit_orbit_result.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)

    print(f"\nfit in {fit_s:.1f}s  "
          f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    print(f"  mass  {args.mass_init:.4f} -> {mass:.4f}  "
          f"(true {args.mass_true}, rel err {100 * mass_rel_err:.3f}%)")
    print(f"  dphi  {args.dphi_init:+.4f} -> {dphi:+.5f}  (true 0)")
    print(f"  roll  {args.de2_init:+.4f} -> {de2:+.5f}  (true 0)")
    print(f"table written to {out}")

    ok = mass_rel_err < 0.01 and abs(dphi) < 0.01 and abs(de2) < 0.01
    print("RECOVERED to <1%" if ok else
          "NOT within 1% -- try more --epochs")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
