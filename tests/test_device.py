"""Device plumbing: compile cache, import hygiene, camera precision and
chip_smoke.py's phases (at tiny size on the CPU; the card runs them at full
size through ``python chip_smoke.py``)."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blackhole_geodesic_calculator_tpu.camera import Camera
from blackhole_geodesic_calculator_tpu.camera.pinhole import (
    euler_matrix, generate_rays, pixel_grid)
from blackhole_geodesic_calculator_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load_smoke()


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


# --- compile cache ------------------------------------------------------------
def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and sets
    nothing in code (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the variable the cache sits at one fixed directory inside the
    checkout, which .gitignore lists."""
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == cache.DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert cache.enable_compile_cache() == path        # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- one process per card -------------------------------------------------------
def test_package_import_initializes_no_backend():
    """Importing the package creates no device client, so a process that
    only imports it (a launcher, the CLI parent) reserves no card memory."""
    code = ("import jax\n"
            "from jax._src import xla_bridge as xb\n"
            "import blackhole_geodesic_calculator_tpu\n"
            "import blackhole_geodesic_calculator_tpu.cli\n"
            "print(sorted(xb._backends))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_cpu_env(), cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_refuses_the_cpu(tmp_path):
    """Without a GPU chip_smoke.py exits non-zero, says why, and prints no
    result line; in a directory without the repo it fails too."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=_cpu_env(), cwd=ROOT)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr + r.stdout
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = _cpu_env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


# --- camera precision -------------------------------------------------------------
def test_camera_directions_match_float64():
    """Ray directions (rotation products in full f32, not TF32) agree with a
    float64 numpy evaluation within 1e-6."""
    cam = Camera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.2, 0.7),
                      fov=(0.9, 0.9))
    w = h = 64
    ys, xs = pixel_grid(w, h)
    _, d = generate_rays(cam, w, h, ys, xs)

    a, b, c = (-0.3, 0.2, 0.7)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                   [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                   [0, 0, 1]])
    rot = rz @ ry @ rx
    ys64, xs64 = np.asarray(ys, np.float64), np.asarray(xs, np.float64)
    xr = 0.9 * (xs64 - w // 2) / w
    yr = 0.9 * (ys64 - h // 2) / h
    dc = np.stack([xr, yr, -np.ones_like(xr)], -1) @ rot.T
    dc /= np.linalg.norm(dc, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(d), dc, atol=1e-6)
    np.testing.assert_allclose(np.asarray(euler_matrix(cam.euler)), rot,
                               atol=1e-6)


# --- chip_smoke phases at tiny size ---------------------------------------------
def test_smoke_phase_kernel_interpret():
    """Phase 2's parity gate on a 512-ray fan, kernel in interpret mode."""
    smoke.phase_kernel(n=512, interpret=True)


def test_smoke_phase_oracle_interpret():
    from blackhole_geodesic_calculator_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    smoke.phase_oracle(interpret=True)


def test_smoke_phase_render_small():
    """Phase 4 at 64^2: the golden scene renders finite and the CLI writes a
    decodable PNG of the example config."""
    smoke.phase_render(size=64)


def test_smoke_phase_train_small():
    """Phase 5 at 16^2: finite loss/gradients, masked mass gradient agrees
    with the XLA path (both XLA on the CPU)."""
    timings = {}
    smoke.phase_train(size=16, timings=timings)
    assert len(timings) == 2


def test_smoke_phase_four_on_virtual_devices():
    """--four at tiny size on four virtual CPU devices: sharded render vs one
    device, (samples=2, rays=2) Trainer gradient vs one device, arrays
    spread over all four devices."""
    assert len(jax.devices()) >= 4
    smoke.phase_four(size=32, train_size=16)


def test_smoke_check_reports_and_raises(capsys):
    smoke.check(True, "fine")
    with pytest.raises(smoke.PhaseFailed):
        smoke.check(False, "broken 1.0 (limit 0.5)")
    out = capsys.readouterr().out
    assert "ok   fine" in out and "FAIL broken" in out


def test_smoke_ray_errors_flags_boundary_ties():
    """The per-ray relative error is scale-aware and catches one-step ties."""
    from blackhole_geodesic_calculator_tpu.ops import states

    n = 4
    x = jnp.asarray([[70.0, 0, 0], [1.0, 0, 0], [0.5, 0, 0], [3.0, 0, 0]])
    p = jnp.ones((n, 3))
    a = states.init_state(x, p, jnp.ones(n))
    b = states.init_state(x.at[0, 0].add(7e-4).at[3, 0].add(7.0), p,
                          jnp.ones(n))
    err, dx, dp = smoke.ray_errors(a, b)
    assert err[0] < 2e-5 and err[3] > 0.5 and dx == pytest.approx(7.0)
    assert dp == 0.0


def test_smoke_one_step_ties_accepts_only_one_rk4_step():
    """A ray counts as a tie only when one RK4 step carries one path's final
    state to the other's: an escape one step later (x, p, lam advance), a
    disk hit frozen at the same point and lam whose p is one step later.
    A wrong momentum with the same status is no tie."""
    import dataclasses

    import bench
    from blackhole_geodesic_calculator_tpu.ops import states
    from blackhole_geodesic_calculator_tpu.ops.integrate import (
        _dt_eff, rk4_step)

    env = smoke.fan_env(jnp.float32(0.5), True, None)
    cfg = bench.make_render_cfg(8, 100).integrator
    x = jnp.asarray([[69.9, 3.0, 1.0], [3.0, 1.0, 0.0], [69.9, 3.0, 1.0],
                     [5.0, 5.0, 5.0]], jnp.float32)
    p = jnp.asarray([[0.9, 0.1, 0.0], [0.1, 0.3, -0.9], [0.9, 0.1, 0.0],
                     [0.0, 0.0, -1.0]], jnp.float32)
    a = dataclasses.replace(
        states.init_state(x, p, jnp.ones(4)),
        lam=jnp.asarray([90.0, 40.0, 90.0, 30.0]),
        status=jnp.asarray([states.ESCAPED, states.DISK, states.ESCAPED,
                            states.DISK], jnp.int32))
    dt = _dt_eff(env, cfg, dataclasses.replace(
        a, status=jnp.full_like(a.status, states.ACTIVE)))
    x1, p1 = rk4_step(env, a.x, a.p, a.E, dt)
    b = dataclasses.replace(
        a, x=a.x.at[0].set(x1[0]), lam=a.lam.at[0].add(dt[0]),
        p=a.p.at[0].set(p1[0]).at[1].set(p1[1]).at[2].add(1e-2))
    err, _, _ = smoke.ray_errors(a, b)
    tie, resid = smoke.one_step_ties(env, cfg, a, b, err)
    assert (err[:3] > smoke.DX_LIMIT).all() and err[3] == 0.0
    assert tie.tolist() == [True, True, False, False]
    assert resid[0] < 1e-5 and resid[1] < 1e-5 and resid[2] > 1e-3
    tie_ba, _ = smoke.one_step_ties(env, cfg, b, a, err)    # either order
    assert tie_ba.tolist() == tie.tolist()


def test_cli_bench_runs_in_process_and_needs_a_gpu(monkeypatch):
    """`bhgc-tpu bench` loads bench.py into the CLI's own process (a child
    would find the card's memory reserved) and bench.py refuses to measure
    anything but a GPU."""
    import subprocess as sp

    from blackhole_geodesic_calculator_tpu import cli

    def no_child(*a, **k):
        raise AssertionError("bench must not start a child process")

    monkeypatch.setattr(sp, "call", no_child)
    monkeypatch.setattr(sp, "Popen", no_child)
    with pytest.raises(SystemExit, match="measures the GPU"):
        cli.main(["bench", "--size", "8", "--steps", "4"])
