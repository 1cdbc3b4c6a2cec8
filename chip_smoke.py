"""Smoke run of the renderer on one NVIDIA GPU: the main path, end to end.

    python chip_smoke.py           # one card: every phase below, in order
    python chip_smoke.py --four    # four cards: the sharded phase only

Phases (one process; the card is opened once):

1. device  -- refuse anything but a GPU; print the card, its power limit,
              JAX's device kind and version.
2. kernel  -- the fused RK4 kernel (ops/pallas_kernel.py) against the XLA
              scan (``integrate_fixed``) on a 1,048,576-ray camera fan, four
              variants: statuses, per-ray error outside verified one-step
              boundary ties, mass gradient.
3. oracle  -- escape directions on the card against the float64
              Dormand-Prince oracle (native/), one flagship pixel budget.
4. render  -- BASELINE config 3 (1024^2 disk + 4 moons) through
              ``render_image`` against its golden, and the same scene file
              through the CLI to a PNG.
5. train   -- one ``Trainer.step`` at 1024^2 (mass, camera, sky texture):
              finite loss and gradients, mass gradient against the pure-XLA
              gradient path.
6. timings -- wall clock of a 1024^2 forward frame (kernel, XLA scan, XLA
              while-loop) and of ``Trainer.step``, compile time apart.

Every number is printed beside its limit; any failed phase makes the exit
code non-zero and suppresses the final JSON line.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FAN_N = 1 << 20
# Kernel-vs-XLA parity limits: both paths run float32 on the same card.
# Per ray, the error is the largest of |dx| / max(1, |x|),
# |dp| / max(1, |p|) and |dlam| / max(1, |lam|): f32 rounding grows with
# the coordinate (an ulp at the escape radius r = 70 is 8e-6).  A ray whose
# step lands within rounding of an escape, capture, disk or sphere boundary
# may stop one step later on one path.  Such a ray counts as a tie only
# when one plain RK4 step from one path's final state reproduces the other
# path's to DX_LIMIT (one_step_ties); at most TIE_SHARE of the rays may be
# ties, and every other ray is held to DX_LIMIT.
DX_LIMIT = 5e-4
TIE_SHARE = 1e-5
DMASS_LIMIT = 1e-3
MASK_CRITICAL = 0.25
GRAD_LR = 1024.0
PIXEL_RAD = 7.8e-4          # one pixel of the 1024 px / 0.8 rad camera
GOLDEN_MEAN, GOLDEN_CELL, GOLDEN_FRAC = 1e-3, 0.05, 0.005


class PhaseFailed(AssertionError):
    pass


def check(ok, msg):
    print(("  ok   " if ok else "  FAIL ") + msg, flush=True)
    if not ok:
        raise PhaseFailed(msg)


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def block(x):
    return jax.block_until_ready(x)


def wall(f, *args, rep=5):
    """(first-call seconds incl. compile, median steady seconds)."""
    t0 = time.perf_counter()
    block(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(rep):
        t0 = time.perf_counter()
        block(f(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


# =============================================================================
# Phase 1: device.
# =============================================================================
def phase_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX platform is {dev.platform!r}); "
            "this script checks the card and never falls back")
    name = card()
    print(name)
    print(f"device_kind={dev.device_kind} jax={jax.__version__} "
          f"devices={len(jax.devices())}", flush=True)
    return name


# =============================================================================
# Phase 2: kernel against the XLA scan at a real width.
# =============================================================================
def fan_env(mass, events, spin):
    from blackhole_geodesic_calculator_tpu.ops import (
        DiskGeom, GeodesicEnv, SphereGeom)

    return GeodesicEnv(
        mass=mass, r_capture=jnp.float32(1.0), r_escape=jnp.float32(70.0),
        lam_max=jnp.float32(100.0),
        spin=None if spin is None else jnp.float32(spin),
        disk=(DiskGeom(r_in=jnp.float32(2.0), r_out=jnp.float32(6.0))
              if events else None),
        # on the fan's footprint in the disk plane (bench.camera_fan is a
        # spiral: b and the azimuth grow together), so every sphere is hit
        spheres=(SphereGeom(
            center=jnp.asarray([[-0.83, -6.47, 0.0], [-3.27, -3.13, 0.4],
                                [5.97, -6.78, 0.3], [-2.94, -0.76, 0.3]],
                               jnp.float32),
            radius=jnp.asarray([1.0, 0.8, 0.6, 0.5], jnp.float32))
            if events else None))


VARIANTS = (("schwarzschild", False, None), ("disk+4 spheres", True, None),
            ("kerr a=0.45", False, 0.45), ("kerr+events", True, 0.45))


def phase_kernel(n=FAN_N, interpret=False):
    import bench
    from blackhole_geodesic_calculator_tpu.ops import states
    from blackhole_geodesic_calculator_tpu.ops.geodesic import null_init
    from blackhole_geodesic_calculator_tpu.ops.integrate import (
        integrate_fixed)
    from blackhole_geodesic_calculator_tpu.ops.pallas_kernel import (
        integrate_pallas)

    cfg = bench.make_render_cfg(8, 100).integrator
    x0, d0 = bench.camera_fan(n)
    b_fan = np.linalg.norm(np.asarray(x0)[:, :2], axis=-1)
    tie_limit = max(1, int(TIE_SHARE * n))

    def run(mass, events, spin, kernel):
        env = fan_env(mass, events, spin)
        p0, e0 = null_init(x0, d0, mass, env.spin)
        s0 = states.init_state(x0, p0, e0)
        if kernel:
            return integrate_pallas(env, s0, cfg, interpret=interpret)
        return integrate_fixed(env, s0, cfg)

    def loss(mass, events, spin, kernel):
        s = run(mass, events, spin, kernel)
        ok = (s.status != states.CAPTURED) & (s.status != states.ERROR)
        return jnp.sum(jnp.where(ok[:, None], s.x ** 2, 0.0)) * 1e-6

    m = jnp.float32(0.5)
    for name, events, spin in VARIANTS:
        t0 = time.perf_counter()
        sk = block(jax.jit(lambda m_: run(m_, events, spin, True))(m))
        comp = time.perf_counter() - t0
        sx = block(jax.jit(lambda m_: run(m_, events, spin, False))(m))
        stk, stx = np.asarray(sk.status), np.asarray(sx.status)
        same = float((stk == stx).mean())
        err, dx, dp = ray_errors(sk, sx)
        tie, resid = one_step_ties(fan_env(m, events, spin), cfg, sk, sx,
                                   err)
        gk = float(jax.jit(jax.grad(
            lambda m_: loss(m_, events, spin, True)))(m))
        gx = float(jax.jit(jax.grad(
            lambda m_: loss(m_, events, spin, False)))(m))
        rel = abs(gk - gx) / max(abs(gx), 1e-12)
        print(f"kernel [{name}] n={n} first call {comp:.1f}s; statuses "
              f"{np.bincount(stk, minlength=8).tolist()}", flush=True)
        check(same == 1.0, f"[{name}] statuses identical: {same:.7f} "
              "(limit 1.0; the fan skips the critical band)")
        print(f"  [{name}] max|dx| = {dx:.3e}, max|dp| = {dp:.3e} (absolute, "
              f"all rays); 99.999th pct relative error "
              f"{np.quantile(err, 0.99999):.3e}", flush=True)
        over = np.flatnonzero(err > DX_LIMIT)
        lk, lx = np.asarray(sk.lam), np.asarray(sx.lam)
        for i in over[np.argsort(-err[over])][:12]:
            print(f"    ray {i} b={b_fan[i]:.5f} status {stx[i]} lam "
                  f"kernel/XLA {lk[i]:.4f}/{lx[i]:.4f} "
                  f"error {err[i]:.3e}; one RK4 step from one path leaves "
                  f"{resid[i]:.3e} to the other -> "
                  f"{'one-step tie' if tie[i] else 'NOT a tie'}", flush=True)
        worst = float(np.where(tie, 0.0, err).max())
        check(worst <= DX_LIMIT, f"[{name}] max relative error over every "
              f"ray but the one-step ties {worst:.3e} (limit {DX_LIMIT:.0e})")
        check(int(tie.sum()) <= tie_limit, f"[{name}] one-step boundary "
              f"ties {int(tie.sum())} (limit {tie_limit})")
        check(rel <= DMASS_LIMIT, f"[{name}] mass gradient kernel "
              f"{gk:.6e} vs XLA {gx:.6e}: rel {rel:.3e} "
              f"(limit {DMASS_LIMIT:.0e})")


def rel_error(xa, pa, la, xb, pb, lb):
    """Per-ray relative error of (x, p, lam) ``a`` against ``b``."""
    err = np.maximum.reduce([
        np.abs(xa - xb).max(-1) / np.maximum(1.0, np.linalg.norm(xb, axis=-1)),
        np.abs(pa - pb).max(-1) / np.maximum(1.0, np.linalg.norm(pb, axis=-1)),
        np.abs(la - lb) / np.maximum(1.0, np.abs(lb))])
    return np.where(np.isfinite(err), err, np.inf)


def ray_errors(a, b):
    """Per-ray relative error of state ``a`` against ``b`` and the absolute
    max |dx|, max |dp|."""
    xa, xb = np.asarray(a.x), np.asarray(b.x)
    pa, pb = np.asarray(a.p), np.asarray(b.p)
    err = rel_error(xa, pa, np.asarray(a.lam), xb, pb, np.asarray(b.lam))
    return (err, float(np.abs(xa - xb).max(initial=0.0)),
            float(np.abs(pa - pb).max(initial=0.0)))


def one_step_ties(env, cfg, a, b, err):
    """Which rays with ``err`` > DX_LIMIT stopped one step apart on paths
    ``a`` and ``b``, and each such ray's residual.

    A ray whose last step lands within rounding of a boundary stops on step
    k on one path and on step k + 1 on the other.  At an escape or capture
    radius, one RK4 step from the earlier final state then reproduces the
    later one: x, p and lam.  At a disk or sphere hit both paths freeze x at
    the same event point with the same lam (the crossing sits at the end of
    step k on one path, t = 1, and at the start of step k + 1 on the other,
    t = 0), so x and lam must agree as they are and the step must carry one
    path's p to the other's.  Both directions are tried; statuses must
    match.  Returns (tie mask, residual: the smaller relative error after
    the step, inf for rays not examined)."""
    from blackhole_geodesic_calculator_tpu.ops import states

    resid = np.full(err.shape, np.inf)
    idx = np.flatnonzero(err > DX_LIMIT)
    sa, sb = np.asarray(a.status), np.asarray(b.status)
    idx = idx[sa[idx] == sb[idx]]
    if idx.size:
        event = np.isin(sb[idx], (states.DISK, states.OBJECT))
        pick = [jax.tree.map(lambda v: np.asarray(v)[idx], s) for s in (a, b)]
        for u, v in (pick, pick[::-1]):
            x1, p1, l1 = map(np.asarray, _rk4_once(env, cfg, u))
            x1 = np.where(event[:, None], u.x, x1)
            l1 = np.where(event, u.lam, l1)
            resid[idx] = np.minimum(resid[idx], rel_error(
                x1, p1, l1, v.x, v.p, v.lam))
    return resid <= DX_LIMIT, resid


@functools.partial(jax.jit, static_argnums=1)
def _rk4_once(env, cfg, s):
    """(x, p, lam) one plain RK4 step past state ``s``, events ignored."""
    from blackhole_geodesic_calculator_tpu.ops import states
    from blackhole_geodesic_calculator_tpu.ops.integrate import (
        _dt_eff, rk4_step)

    dt = _dt_eff(env, cfg, dataclasses.replace(
        s, status=jnp.full_like(s.status, states.ACTIVE)))
    x1, p1 = rk4_step(env, s.x, s.p, s.E, dt)
    return x1, p1, s.lam + dt


# =============================================================================
# Phase 3: accuracy against the float64 oracle.
# =============================================================================
def phase_oracle(interpret=False):
    from blackhole_geodesic_calculator_tpu import native
    from blackhole_geodesic_calculator_tpu.ops import (
        GeodesicEnv, IntegratorConfig, states)
    from blackhole_geodesic_calculator_tpu.ops.geodesic import null_init
    from blackhole_geodesic_calculator_tpu.ops.integrate import (
        final_direction, integrate)
    from blackhole_geodesic_calculator_tpu.ops.pallas_kernel import (
        integrate_pallas)

    check(native.available(), "native f64 oracle builds and loads")
    # the fan of tests/test_native.py::test_bench_schedule_accuracy
    n = 97
    b = np.concatenate([np.linspace(2.0, 3.5, 49),
                        np.linspace(3.6, 15.0, n - 49)])
    x0 = np.stack([b, np.zeros(n), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    oracle = native.integrate_batch(x0, d0, mass=0.5, r_capture=1.0,
                                    r_escape=70.0, lam_max=100.0,
                                    rtol=1e-11, atol=1e-13)
    env = GeodesicEnv(mass=jnp.float32(0.5), r_capture=jnp.float32(1.0),
                      r_escape=jnp.float32(70.0),
                      lam_max=jnp.float32(100.0))
    cfg = IntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                           dt_boost_r_ref=1.7, dt_power=1.5)
    x0j, d0j = jnp.asarray(x0, jnp.float32), jnp.asarray(d0, jnp.float32)
    p0, e0 = null_init(x0j, d0j, env.mass, None)
    s0 = states.init_state(x0j, p0, e0)
    s = (integrate_pallas(env, s0, cfg, interpret=True) if interpret
         else jax.jit(lambda s_: integrate(env, s_, cfg))(s0))
    st = np.asarray(s.status)
    check(bool((st != states.ACTIVE).all()), "every oracle-fan ray finished")
    cap = st == states.CAPTURED
    check(bool((cap == (oracle["status"] == states.CAPTURED)).all()),
          "capture set equals the oracle's")
    esc = (st == states.ESCAPED) & (oracle["status"] == states.ESCAPED)
    d_card = np.asarray(final_direction(env, s))[esc]
    d_o = np.stack([native.rhs(oracle["x"][i], oracle["p"][i],
                               native.null_init(x0[i], d0[i], 0.5,
                                                None)[1], 0.5, None)[0]
                    for i in range(n)])[esc]
    d_o /= np.linalg.norm(d_o, axis=1, keepdims=True)
    ang = float(np.arccos(np.clip(np.sum(d_card * d_o, -1), -1, 1)).max())
    check(ang <= PIXEL_RAD, f"worst escape-direction error vs f64 oracle "
          f"{ang:.3e} rad over {int(esc.sum())} rays (limit {PIXEL_RAD:.1e} "
          "rad, one flagship pixel)")


# =============================================================================
# Phase 4: BASELINE config 3 forward, against the golden and via the CLI.
# =============================================================================
def golden_scene(size=1024):
    """The exact scene and config of
    tests/test_golden_baseline.py::test_golden_1024_disk_and_four_moons,
    with backend='auto' so the kernel serves it on a GPU."""
    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig
    from blackhole_geodesic_calculator_tpu.render import RenderConfig
    from blackhole_geodesic_calculator_tpu.scene import (
        BlackHole, Disk, Scene, Spheres)

    h, w = 64, 128
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = jnp.asarray(np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // 8 + v // 8) % 2).astype(np.float32)], -1), jnp.float32)
    disk_tex = jnp.broadcast_to(jnp.asarray([1.0, 0.6, 0.2]), (8, 32, 3))
    moons = np.zeros((4, 8, 8, 3), np.float32)
    for k in range(4):
        moons[k, ..., k % 3] = 1.0
    scene = Scene(
        bh=BlackHole.make(mass=0.5), background=sky,
        disk=Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex),
        spheres=Spheres.make(
            center=[[6.0, 2.0, 6.0], [-5.0, -2.0, -8.0],
                    [0.0, 4.0, -10.0], [8.0, -1.0, -3.0]],
            radius=[0.8, 0.8, 0.6, 0.5], texture=moons))
    cam = Camera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.0, 0.0),
                      fov=(0.9, 0.9))
    cfg = RenderConfig(
        width=size, height=size, samples=1,
        integrator=IntegratorConfig(n_steps=400, dt=0.06, dt_boost=48.0,
                                    dt_boost_r_ref=1.6, dt_power=1.5,
                                    backend="auto"),
        lam_max=120.0)
    return scene, cam, cfg


def pool4(img):
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).mean((1, 3))


def golden_diff(img, ref_small):
    """(mean |d|, share of 4x-pooled cells off by > GOLDEN_CELL)."""
    small = pool4(np.asarray(img, np.float32)).astype(np.float16)
    d = np.abs(small.astype(np.float32) - np.asarray(ref_small, np.float32))
    return float(d.mean()), float((d > GOLDEN_CELL).mean())


def check_golden(label, img, ref_small):
    mean, frac = golden_diff(img, ref_small)
    check(mean < GOLDEN_MEAN, f"{label}: mean |d| {mean:.3e} "
          f"(limit {GOLDEN_MEAN:.0e}, 4x-pooled)")
    check(frac < GOLDEN_FRAC, f"{label}: {100 * frac:.3f}% of pooled cells "
          f"off by > {GOLDEN_CELL} (limit {100 * GOLDEN_FRAC:.1f}%)")


def phase_render(size=1024):
    from blackhole_geodesic_calculator_tpu import cli
    from blackhole_geodesic_calculator_tpu.io_ import read_image
    from blackhole_geodesic_calculator_tpu.render import render_image

    scene, cam, cfg = golden_scene(size)
    t0 = time.perf_counter()
    img = np.asarray(block(render_image(scene, cam, cfg)))
    print(f"render_image {size}^2 disk + 4 moons: first call "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(bool(np.isfinite(img).all()), "render is finite")
    if size == 1024:
        with np.load(os.path.join(ROOT, "tests", "golden",
                                  "disk_four_moons_1024.npz")) as z:
            check_golden("golden disk_four_moons_1024", img, z["img"])

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "disk.png")
        args = ["render", os.path.join(ROOT, "examples", "disk_moons.json"),
                "-o", out]
        if size != 1024:
            args += ["--width", str(size), "--height", str(size)]
        t0 = time.perf_counter()
        cli.main(args)
        png = read_image(out)
        print(f"cli render examples/disk_moons.json: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    check(png.shape == (size, size, 3), f"CLI PNG decodes as {png.shape} "
          f"(expected {(size, size, 3)})")
    check(bool(np.isfinite(png).all()), "CLI PNG holds no NaN")


# =============================================================================
# Phase 5: forward + backward through Trainer.step.
# =============================================================================
def make_trainer(size, backend, devices, sample_parallel=1, samples=1,
                 mask=None):
    import optax

    import bench
    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.parallel import Trainer, make_mesh
    from blackhole_geodesic_calculator_tpu.parallel.mesh import put_global
    from blackhole_geodesic_calculator_tpu.render import render_image
    from jax.sharding import NamedSharding, PartitionSpec as P

    sky = bench.make_sky()
    scene0 = bench.make_scene("sky", sky)
    cam = Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8))
    cfg = bench.make_render_cfg(size, 100, samples=samples)
    cfg = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend=backend))

    def param_fn(p):
        s = dataclasses.replace(
            scene0, bh=dataclasses.replace(scene0.bh, mass=p["mass"]),
            background=p["background"])
        return s, dataclasses.replace(cam, position=p["cam_pos"])

    mesh = make_mesh(devices, sample_parallel=sample_parallel)
    # One SGD step moves each parameter by -GRAD_LR * gradient; a power of
    # two large enough that the f32 rounding of the updated parameter
    # (an ulp of a texel near 0.5 is 6e-8) stays far below the gradient.
    tr = Trainer(cfg=cfg, param_fn=param_fn, optimizer=optax.sgd(GRAD_LR),
                 mesh=mesh, mask_critical=mask)
    target = np.asarray(render_image(scene0, cam, dataclasses.replace(
        cfg, integrator=dataclasses.replace(cfg.integrator,
                                            backend="scan"))))[..., :3]
    tf, ys, xs = tr.shard_target(target)
    params = put_global({"mass": jnp.float32(0.45), "cam_pos": cam.position,
                         "background": sky}, tr._repl)
    opt = tr.init(params)
    keys = put_global(jax.random.split(jax.random.PRNGKey(0),
                                       max(samples, sample_parallel)),
                      NamedSharding(mesh, P("samples")))

    def step():
        return tr.step(params, opt, tf, ys, xs, keys)

    def grads(out):
        p1 = out[0]
        return {k: (np.asarray(params[k], np.float64)
                    - np.asarray(p1[k], np.float64)) / GRAD_LR
                for k in params}

    def reference_grads():
        """On ONE device, exactly the loss this step takes on its mesh:
        sample row s renders each ray shard r with its own key (jitter is
        drawn per shard), and the step averages the per-device losses."""
        from blackhole_geodesic_calculator_tpu.parallel.render import (
            _flat_pixels)
        from blackhole_geodesic_calculator_tpu.render.renderer import (
            render_rays)

        n_smp, n_ray = tr._n_smp, tr._n_ray
        ys1, xs1, perm, _ = _flat_pixels(cfg, n_ray)
        tgt = jnp.asarray(target.reshape(-1, 3)[np.asarray(perm)])
        per = ys1.shape[0] // n_ray
        keys1 = jax.random.split(jax.random.PRNGKey(0), n_smp)

        def loss(p):
            scene, c = param_fn(p)
            terms = []
            for si in range(n_smp):
                for r in range(n_ray):
                    sl = slice(r * per, (r + 1) * per)
                    rgb = render_rays(scene, c, cfg, ys1[sl], xs1[sl],
                                      keys1[si] if samples > 1 else None)
                    w = tr._critical_weights(scene, c, ys1[sl], xs1[sl]) \
                        if mask is not None else jnp.ones(per)
                    terms.append(jnp.sum(w[:, None] * (rgb - tgt[sl]) ** 2)
                                 / (jnp.maximum(jnp.sum(w), 1.0) * 3))
            return sum(terms) / len(terms)

        host = {"mass": jnp.float32(0.45), "cam_pos": cam.position,
                "background": sky}
        g = jax.jit(jax.grad(loss))(host)
        return {k: np.asarray(v, np.float64) for k, v in g.items()}

    return SimpleNamespace(step=step, grads=grads, target=tf,
                           reference_grads=reference_grads)


def phase_train(size=1024, timings=None):
    """One Trainer.step through the kernel: finite loss and gradients.  The
    mass gradient is compared with the pure-XLA path on the loss with the
    critical band masked (Trainer.mask_critical): pointwise gradients of
    rays that wind around the photon sphere grow exponentially with the
    winding, so last-bit differences between any two compilations make
    them disagree at O(1) while the rest of the image agrees."""
    tk = make_trainer(size, "auto", jax.devices()[:1])
    first, t = wall(tk.step, rep=3)
    out = tk.step()
    loss = float(out[2])
    gk = tk.grads(out)
    check(np.isfinite(loss), f"Trainer.step loss {loss:.6e} is finite")
    for k, g in gk.items():
        check(bool(np.isfinite(g).all()), f"gradient of {k} is finite "
              f"(|g|max {np.abs(g).max():.3e})")
    tx = make_trainer(size, "scan", jax.devices()[:1])
    first_x, t_x = wall(tx.step, rep=3)
    gm = {}
    for backend in ("auto", "scan"):
        tm = make_trainer(size, backend, jax.devices()[:1],
                          mask=MASK_CRITICAL)
        gm[backend] = float(tm.grads(tm.step())["mass"])
    rel = abs(gm["auto"] - gm["scan"]) / max(abs(gm["scan"]), 1e-12)
    check(rel <= DMASS_LIMIT, f"Trainer.step mass gradient (critical band "
          f"|ell/ell_c - 1| < {MASK_CRITICAL} masked) kernel "
          f"{gm['auto']:.6e} vs XLA {gm['scan']:.6e}: rel {rel:.3e} "
          f"(limit {DMASS_LIMIT:.0e})")
    if timings is not None:
        timings["Trainer.step (kernel fwd, XLA segment adjoint)"] = (first, t)
        timings["Trainer.step (XLA scan autodiff)"] = (first_x, t_x)


# =============================================================================
# Phase 6: timings.
# =============================================================================
def phase_timings(name, timings, size=1024):
    import bench
    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.render import render_image

    sky = bench.make_sky()
    for kind in ("sky", "events"):
        scene = bench.make_scene(kind, sky)
        cam = Camera.make(position=(0.0, 0.0, 25.0),
                          euler=(0.25, 0.0, 0.0) if kind == "events"
                          else (0.0, 0.0, 0.0), fov=(0.8, 0.8))
        for label, backend, mode in (("kernel", "auto", "scan"),
                                     ("XLA integrate_fixed", "scan", "scan"),
                                     ("XLA integrate_fixed_fast", "scan",
                                      "while")):
            cfg = bench.make_render_cfg(size, 100)
            cfg = dataclasses.replace(cfg, integrator=dataclasses.replace(
                cfg.integrator, backend=backend, mode=mode))
            f = jax.jit(lambda s, c, cfg=cfg: render_image(s, c, cfg))
            timings[f"forward {size}^2 {kind} frame, {label}"] = wall(
                f, scene, cam)
    print(f"timings [{name}] (median of steady calls; first call includes "
          "compile):")
    for k, (first, t) in timings.items():
        print(f"  {k}: {t * 1e3:.3f} ms (first call {first:.2f} s)")


# =============================================================================
# --four: the sharded path on four cards.
# =============================================================================
def spread(arr, n):
    devs = {s.device for s in arr.addressable_shards}
    return len(arr.sharding.device_set) == n and len(devs) == n


def phase_four(size=4096, train_size=1024, n_dev=4):
    from blackhole_geodesic_calculator_tpu.parallel import (
        make_mesh, render_image_sharded)
    from blackhole_geodesic_calculator_tpu.render import render_image

    devs = jax.devices()
    check(len(devs) >= n_dev, f"{len(devs)} devices visible (need {n_dev})")
    devs = devs[:n_dev]
    mesh = make_mesh(devs)
    scene, cam, cfg = golden_scene(size)
    t0 = time.perf_counter()
    img = block(render_image_sharded(scene, cam, cfg, mesh))
    print(f"render_image_sharded {size}^2 on mesh {dict(mesh.shape)}: first "
          f"call {time.perf_counter() - t0:.1f}s", flush=True)
    first, t = wall(lambda: render_image_sharded(scene, cam, cfg, mesh),
                    rep=3)
    print(f"  steady {t * 1e3:.1f} ms", flush=True)
    ref = np.asarray(block(render_image(scene, cam, cfg)))
    first1, t1 = wall(lambda: render_image(scene, cam, cfg), rep=3)
    print(f"render_image {size}^2 on one card: steady {t1 * 1e3:.1f} ms",
          flush=True)
    check(bool(np.isfinite(np.asarray(img)).all()), "sharded render finite")
    check_golden(f"sharded {size}^2 vs one card", np.asarray(img),
                 pool4(ref).astype(np.float16))

    t4 = make_trainer(train_size, "auto", devs, sample_parallel=2,
                      samples=2, mask=MASK_CRITICAL)
    out4 = t4.step()
    first4, step_t4 = wall(t4.step, rep=3)
    t1 = make_trainer(train_size, "auto", devs[:1], samples=2,
                      mask=MASK_CRITICAL)
    first1, step_t1 = wall(t1.step, rep=3)
    print(f"Trainer.step {train_size}^2 samples=2: (samples=2, rays=2) mesh "
          f"{step_t4 * 1e3:.1f} ms, one card {step_t1 * 1e3:.1f} ms",
          flush=True)
    # Whole-array relative error: the texture gradient is a scatter-add of
    # many rays per texel, summed in another order on each mesh.
    g4, g1 = t4.grads(out4), t4.reference_grads()
    for k in g4:
        rel = float(np.linalg.norm(g4[k] - g1[k])
                    / max(np.linalg.norm(g1[k]), 1e-12))
        worst = float(np.abs(g4[k] - g1[k]).max()
                      / max(np.abs(g1[k]).max(), 1e-12))
        check(rel <= DMASS_LIMIT, f"4-card gradient of {k} vs the same loss "
              f"on one card: |dg|/|g| {rel:.3e} (limit {DMASS_LIMIT:.0e}; "
              f"worst element {worst:.3e} of max |g|)")
    # the per-device programs really ran on all four cards
    check(spread(out4[0]["background"], n_dev),
          f"Trainer parameters live on all {n_dev} devices")
    check(spread(t4.target, n_dev), f"Trainer's ray-sharded target spans all "
          f"{n_dev} devices")
    check(spread(img, n_dev), f"sharded render output spans all {n_dev} "
          "devices")


# =============================================================================
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    from blackhole_geodesic_calculator_tpu.utils import enable_compile_cache

    name = phase_device()          # exits non-zero without a GPU
    enable_compile_cache()
    timings = {}
    phases = ([("four", phase_four)] if args.four else [
        ("kernel", phase_kernel),
        ("oracle", phase_oracle),
        ("render", phase_render),
        ("train", lambda: phase_train(timings=timings)),
        ("timings", lambda: phase_timings(name, timings)),
    ])
    failed = []
    for label, fn in phases:
        print(f"== phase {label}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(label)
        print(f"== phase {label}: {'FAILED' if label in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"card: {name}")
    if failed:
        print(f"chip_smoke FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
