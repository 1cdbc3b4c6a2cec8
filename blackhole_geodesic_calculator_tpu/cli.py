"""Command-line interface.

The reference's CLI story is ``blender -b scene.blend -f N`` plus a
depsgraph re-eval hack (RelativisticRenderEngine.py:140-141, milestone
"V Commandline rendering" README.md:238).  Standalone subcommands:

  render             scene config JSON -> PNG (progressive sample output)
  animate            orbit-animation frames (the reference's 100-frame
                     renders, README.md:8-9)
  precompute-camera  Gen-3 ray-field precompute -> npz
                     (RelativisticRenderEngineCamEdition.py:206-221)
  bench              rays/s measurement (same harness as bench.py)

Run as ``python -m blackhole_geodesic_calculator_tpu.cli <cmd> ...``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def _cmd_render(args):
    import jax

    from .io_ import build_scene, load_config, tonemap, write_png
    from .render import render_progressive

    cfg = load_config(args.config)
    if args.width:
        cfg.width = args.width
    if args.height:
        cfg.height = args.height
    scene, cam, rcfg = build_scene(cfg)

    if args.verbose:
        from .render import render_stats

        st = render_stats(scene, cam, rcfg)
        print(json.dumps(st, indent=2))

    t0 = time.perf_counter()
    if args.stokes and cfg.engine == "limited":
        # no polarized path exists for the Gen-1 hybrid; silently falling
        # back to the whole-scene engine would mislabel the output
        raise SystemExit("--stokes is not supported with engine='limited' "
                         "(polarized rendering is a whole-scene path); "
                         "drop --stokes or set engine='whole'")
    if args.stokes:
        # Polarized rendering: Stokes I/Q/U (render.render_stokes; needs a
        # disk with pol_frac, e.g. SceneConfig.disk_pol_frac > 0).  The RGB
        # image goes to --out as usual; the raw Stokes planes (science
        # data: float Q/U in camera axes + I luminance) to a sibling npz,
        # plus a quick-look polarized-fraction PNG sqrt(Q^2+U^2)/I.
        from .render import render_stokes

        rgb, Q, U = [np.asarray(a) for a in jax.block_until_ready(
            render_stokes(scene, cam, rcfg))]
        I = rgb.mean(-1)
        base = os.path.splitext(args.out)[0]
        np.savez(base + "_stokes.npz", rgb=rgb, I=I, Q=Q, U=U)
        with np.errstate(invalid="ignore", divide="ignore"):
            pfrac = np.where(I > 0, np.hypot(Q, U) / np.maximum(I, 1e-20), 0.0)
        write_png(base + "_pfrac.png",
                  np.clip(pfrac, 0.0, 1.0)[..., None].repeat(3, -1))
        # render_stokes returns crop-window-shaped planes; embed the RGB
        # into the full ones-initialized frame at the crop offsets so the
        # --out PNG follows the same convention as the non-stokes path
        # (white border, full width x height).
        x0, x1, y0, y1 = rcfg.crop()
        img = np.ones((rcfg.height, rcfg.width, 4), rgb.dtype)
        img[y0:y1, x0:x1, :3] = rgb
        print(f"wrote {base}_stokes.npz (I/Q/U) and {base}_pfrac.png")
    elif cfg.engine == "limited":
        # Gen-1 sphere-of-influence hybrid engine (reference
        # LimitedRelativisticRenderEngine; render/limited.py), incl. the
        # approx surrogate backends: the exact Schwarzschild table or a
        # trained NeuralSurrogate npz (SceneConfig.surrogate_path).
        from .io_.config import build_limited
        from .render import render_limited

        lcfg, table = build_limited(cfg)
        img = np.asarray(jax.block_until_ready(
            render_limited(scene, cam, rcfg, lcfg, table=table)))
    else:
        img = None
        unit = "sample" if rcfg.samples > 1 else "band"
        for i, frame in render_progressive(scene, cam, rcfg):
            img = frame
            if args.verbose:
                print(f"{unit} {i + 1} ({time.perf_counter() - t0:.1f}s)")
        img = np.asarray(jax.block_until_ready(img))
    if args.tonemap:
        img = np.concatenate([tonemap(img[..., :3]), img[..., 3:]], -1)
    write_png(args.out, img)
    print(f"wrote {args.out} ({rcfg.width}x{rcfg.height}, "
          f"{rcfg.samples} spp, {time.perf_counter() - t0:.1f}s)")


def _cmd_animate(args):
    import jax

    from .io_ import build_scene, load_config, write_png
    from .render import render_image_u8

    cfg = load_config(args.config)
    scene, cam, rcfg = build_scene(cfg)
    r = float(np.linalg.norm(np.asarray(cfg.camera_location)
                             - np.asarray(cfg.bh_loc)))

    # Async IO pipeline: the native thread pool tonemaps/encodes/writes the
    # previous frame while the device renders the next one.
    writer = None
    try:
        from . import native

        if native.available():
            writer = native.FrameWriter(threads=4)
    except Exception:
        writer = None

    # Frame files are written atomically (tmp + rename, both the native
    # FrameWriter and write_png), so an existing file is a complete frame
    # -- a crash mid-write never leaves a truncated PNG that --resume
    # would treat as done.
    todo = []
    for f in range(args.frames):
        path = args.out_pattern.format(frame=f)
        if args.resume and os.path.exists(path):
            print(f"frame {f + 1}/{args.frames} exists, skipping")
        else:
            todo.append((f, path))

    def dispatch(f):
        # orbit in the x-z plane looking at the hole: euler_y = phi turns
        # the camera's -z axis onto -(sin phi, 0, cos phi); tonemap +
        # quantize ON DEVICE -- the device->host transfer of a uint8 frame
        # is 4x smaller than f32 (see render_image_u8)
        phi = 2.0 * np.pi * f / args.frames
        pos = np.asarray(cfg.bh_loc) + r * np.asarray(
            [np.sin(phi), 0.0, np.cos(phi)])
        cam_f = dataclasses.replace(
            cam,
            position=jax.numpy.asarray(pos, jax.numpy.float32),
            euler=jax.numpy.asarray([0.0, phi, 0.0], jax.numpy.float32))
        return render_image_u8(scene, cam_f, rcfg, tonemap=args.tonemap)

    render_error = False
    try:
        # double-buffered: frame i+1 is dispatched BEFORE frame i is
        # fetched, so the device renders ahead while the host pulls the
        # previous frame (frame time = max(compute, transfer), not the sum)
        pending = dispatch(todo[0][0]) if todo else None
        for i, (f, path) in enumerate(todo):
            nxt = dispatch(todo[i + 1][0]) if i + 1 < len(todo) else None
            img = np.asarray(pending)
            pending = nxt
            if writer is not None:
                writer.submit(path, img)
            else:
                write_png(path, img)
            print(f"frame {f + 1}/{args.frames} -> {path}")
    except BaseException:
        render_error = True
        raise
    finally:
        if writer is not None:
            failures = writer.wait()
            writer.close()
            # don't mask an exception already propagating from the loop
            if failures and not render_error:
                raise RuntimeError(f"{failures} frame writes failed")


def _cmd_precompute(args):
    from .compat import RelativisticCamera

    cam = RelativisticCamera(
        resolution=(args.res, args.res),
        field_of_view=(args.fov, args.fov),
        a=args.a, mass=args.mass,
        camera_location=tuple(args.camera),
        max_step=args.max_step, curve_end=args.curve_end,
    )
    t0 = time.perf_counter()
    cam.run(verbose=True)
    cam.save(args.out)
    print(f"wrote {args.out} ({time.perf_counter() - t0:.1f}s)")


def _cmd_train_surrogate(args):
    """Train the learned scattering surrogate against the live integrator
    and save it as npz (loadable via SceneConfig.surrogate_path or
    models.surrogate.load_surrogate) -- the CLI face of the reference's
    planned 'Tensorflow model' approx backend (README.md:237)."""
    import jax

    from .models.surrogate import (SurrogateConfig, evaluate_surrogate,
                                   save_surrogate, train_surrogate)

    cfg = SurrogateConfig(width=args.width, depth=args.depth,
                          r_influence=args.ratio,
                          exit_tolerance=args.exit_tolerance)
    t0 = time.perf_counter()
    sur, hist = train_surrogate(
        jax.random.PRNGKey(args.seed), mass=args.mass,
        spin=(args.a if args.a != 0.0 else None), cfg=cfg,
        steps=args.steps, batch=args.batch, log_every=max(args.steps // 10,
                                                          1))
    # save FIRST: an eval hiccup must not discard a finished training run
    save_surrogate(args.out, sur)
    m = evaluate_surrogate(jax.random.PRNGKey(args.seed + 1), sur, cfg,
                           n=1 << 15)
    print(f"trained {args.steps} steps x {args.batch} rays in "
          f"{time.perf_counter() - t0:.1f}s; loss "
          f"{hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")
    print(f"held-out vs integrator: capture acc "
          f"{100 * m['capture_acc']:.2f}%, median dir err "
          f"{m['dir_err_median_rad']:.2e} rad (p95 "
          f"{m['dir_err_p95_rad']:.2e})")
    print(f"wrote {args.out}")


def _cmd_profile_train(args):
    """Profile ONE sharded training step (the BASELINE config-5 shape:
    ray-sharded render, replicated params, gradient all-reduce) and report
    the per-op device-time table plus the collective share / overlap -- the
    measured answer to "is the psum overlapped with the backward".  Run with
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
    for the virtual-mesh measurement, or on the GPU(s) directly."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from .camera import Camera
    from .ops import IntegratorConfig
    from .parallel import Trainer, make_mesh
    from .parallel.mesh import put_global
    from .render import RenderConfig, render_image
    from .scene import BlackHole, Scene
    from .utils.profiling import (
        collective_report, format_op_table, op_table, trace,
    )

    n = args.size
    devices = jax.devices()
    mesh = make_mesh(devices)
    print(f"devices={len(devices)} ({devices[0].device_kind}) "
          f"mesh={dict(mesh.shape)} size={n} steps={args.steps}")

    h, w = 32, 64
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = jnp.asarray(np.stack(
        [0.5 + 0.5 * np.sin(2 * np.pi * u / w), v / h,
         0.3 + 0.0 * u], -1), jnp.float32)
    scene0 = Scene(bh=BlackHole.make(mass=0.5), background=sky)
    cam = Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8))
    cfg = RenderConfig(
        width=n, height=n, samples=1,
        integrator=IntegratorConfig(n_steps=args.steps, dt=0.12,
                                    dt_boost=64.0, dt_boost_r_ref=1.7,
                                    dt_power=1.5),
        lam_max=100.0)

    def param_fn(p):
        s = dc.replace(scene0, bh=dc.replace(scene0.bh, mass=p["mass"]),
                       background=p["background"])
        return s, dc.replace(cam, position=p["cam_pos"])

    params = {"mass": jnp.asarray(0.45), "cam_pos": cam.position,
              "background": sky}
    target = render_image(scene0, cam, cfg)[..., :3]

    tr = Trainer(cfg=cfg, param_fn=param_fn,
                 optimizer=optax.adam(1e-2), mesh=mesh)
    target_flat, ys, xs = tr.shard_target(target)
    params = put_global(params, tr._repl)
    opt_state = tr.init(params)
    from jax.sharding import NamedSharding, PartitionSpec as P

    keys = put_global(jnp.zeros((tr._n_smp, 2), jnp.uint32),
                      NamedSharding(mesh, P("samples")))

    def step():
        return tr.step(params, opt_state, target_flat, ys, xs, keys)

    out = step()          # compile + warm
    jax.block_until_ready(out)

    import tempfile
    import time

    logdir = tempfile.mkdtemp(prefix="bgc_train_prof_")
    t0 = time.perf_counter()
    with trace(logdir):
        for _ in range(args.repeats):
            out = step()
        jax.tree.map(lambda a: a.block_until_ready(), out)
    wall = (time.perf_counter() - t0) / args.repeats
    print(f"\nwall per step: {wall*1e3:.1f} ms")
    print("\nper-op device time (top 15):")
    print(format_op_table(op_table(logdir, top=15, repeats=args.repeats)))
    rep = collective_report(logdir, repeats=args.repeats)
    print(f"\ncollectives: {rep['collective_ms']:.3f} ms/step of "
          f"{rep['compute_ms'] + rep['collective_ms']:.3f} ms total device "
          f"time = {rep['collective_share']*100:.2f}% share; "
          f"overlap with compute {rep['overlap_fraction']*100:.1f}%")
    for name, ms in rep["top_collectives"]:
        print(f"  {ms:9.3f} ms  {name[:70]}")
    import shutil

    shutil.rmtree(logdir, ignore_errors=True)


def _cmd_bench(args):
    """Run bench.py IN THIS PROCESS: a child process would find the card's
    memory already reserved by this one."""
    import importlib.util

    # bench.py lives at the repo root (one level above the package); an
    # absolute path keeps `cli bench` working from any cwd.
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "bench.py")
    if not os.path.exists(path):
        path = "bench.py"  # installed layout: fall back to cwd
    spec = importlib.util.spec_from_file_location("bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    argv = ["--size", str(args.size), "--steps", str(args.steps)]
    if args.fwd_only:
        argv.append("--fwd-only")
    bench.main(argv)


def main(argv=None):
    from .utils import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="blackhole_geodesic_calculator_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene config to PNG")
    p.add_argument("config")
    p.add_argument("-o", "--out", default="render.png")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--tonemap", action="store_true")
    p.add_argument("--stokes", action="store_true",
                   help="polarized rendering: write Stokes I/Q/U planes to "
                   "<out>_stokes.npz + a polarized-fraction quick-look PNG "
                   "(requires disk_pol_frac > 0 in the config)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=_cmd_render)

    p = sub.add_parser("animate", help="render an orbit animation")
    p.add_argument("config")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--out-pattern", default="frame_{frame:04d}.png")
    p.add_argument("--tonemap", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose output file already exists "
                   "(renders are deterministic, so a resumed animation is "
                   "bit-identical to an uninterrupted one)")
    p.set_defaults(fn=_cmd_animate)

    p = sub.add_parser("precompute-camera",
                       help="Gen-3 ray-field precompute -> npz")
    p.add_argument("-o", "--out", default="camera.npz")
    p.add_argument("--res", type=int, default=124)
    p.add_argument("--fov", type=float, default=0.3)
    p.add_argument("--a", type=float, default=0.0)
    p.add_argument("--mass", type=float, default=0.5)
    p.add_argument("--camera", type=float, nargs=3,
                   default=[0.0, 0.0, 25.0])
    p.add_argument("--max-step", type=float, default=0.1)
    p.add_argument("--curve-end", type=float, default=100.0)
    p.set_defaults(fn=_cmd_precompute)

    p = sub.add_parser("train-surrogate",
                       help="train the learned (MLP) scattering surrogate "
                       "against the integrator -> npz")
    p.add_argument("-o", "--out", default="surrogate.npz")
    p.add_argument("--mass", type=float, default=0.5)
    p.add_argument("--a", type=float, default=0.45,
                   help="Kerr spin (0 -> Schwarzschild)")
    p.add_argument("--ratio", type=float, default=20.0,
                   help="influence-sphere radius (ratio_obj_to_blackhole)")
    p.add_argument("--exit-tolerance", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_train_surrogate)

    p = sub.add_parser("profile-train",
                       help="profile one sharded training step: op table "
                       "+ collective share/overlap (BASELINE config 5)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--repeats", type=int, default=3)
    p.set_defaults(fn=_cmd_profile_train)

    p = sub.add_parser("bench", help="run the rays/s benchmark")
    p.add_argument("--size", type=int, default=1024)
    # keep in lockstep with bench.py's oracle-validated default schedule
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--fwd-only", action="store_true")
    p.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
