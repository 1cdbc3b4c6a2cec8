"""Native C++ runtime tests: f64 oracle parity with the JAX paths, image IO
roundtrips, and the async frame writer.

The oracle (native/src/geodesic.cpp) is an adaptive Dormand-Prince 5(4) in
double precision -- the closest twin of the reference's scipy solve_ivp RK45
layer (reference RelativisticRenderEngine.py:293-294, README.md:196).  The
JAX fixed-step integrator (ops/integrate.py) is tested AGAINST it here: both
must agree on physics (deflection angles, termination taxonomy, conserved
Hamiltonian) to f32 render tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from blackhole_geodesic_calculator_tpu import native
from blackhole_geodesic_calculator_tpu.ops import states
from blackhole_geodesic_calculator_tpu.ops import geodesic as g
from blackhole_geodesic_calculator_tpu.ops.integrate import (
    GeodesicEnv, IntegratorConfig, launch, final_direction,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable")


def test_status_codes_match_states():
    assert native.ACTIVE == states.ACTIVE
    assert native.CAPTURED == states.CAPTURED
    assert native.ESCAPED == states.ESCAPED
    assert native.BUDGET == states.BUDGET
    assert native.DISK == states.DISK
    assert native.OBJECT == states.OBJECT
    assert native.INSIDE_HORIZON == states.INSIDE_HORIZON
    assert native.ERROR == states.ERROR


@pytest.mark.parametrize("spin", [None, 0.3, 0.9, -0.5])
def test_rhs_parity_vs_jax(rng, spin):
    """C++ analytic Kerr-Schild gradient == JAX autodiff of the potential."""
    for _ in range(10):
        x = rng.normal(size=3) * 4.0
        x[2] += 0.5
        p = rng.normal(size=3)
        E = 1.0 + 0.1 * rng.random()
        dxn, dpn = native.rhs(x, p, E, 0.5, spin)
        dxj, dpj = g.ks_rhs(jnp.asarray(x, jnp.float32),
                            jnp.asarray(p, jnp.float32),
                            jnp.float32(E), 0.5, spin)
        np.testing.assert_allclose(dxn, np.asarray(dxj), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(dpn, np.asarray(dpj), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("spin", [None, 0.7])
def test_null_init_parity(rng, spin):
    x = np.asarray([3.0, 1.5, -2.0])
    for _ in range(5):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        pn, En = native.null_init(x, d, 0.5, spin)
        pj, Ej = g.null_init(jnp.asarray(x, jnp.float32),
                             jnp.asarray(d, jnp.float32), 0.5, spin)
        np.testing.assert_allclose(pn, np.asarray(pj), atol=2e-6)
        assert abs(En - float(Ej)) < 2e-6
        # the constructed state is exactly null
        q, l3, _ = g.ks_fields(jnp.asarray(x, jnp.float32), 0.5, spin)
        assert abs(float(g.hamiltonian(
            jnp.asarray(x, jnp.float32), jnp.asarray(pn, jnp.float32),
            jnp.float32(En), 0.5, spin))) < 1e-5


def test_flat_space_straight_lines():
    """mass = 0: the oracle must reproduce straight rays exactly."""
    n = 64
    x0 = np.tile([0.0, 0.0, 20.0], (n, 1))
    th = np.linspace(-0.4, 0.4, n)
    d0 = np.stack([np.sin(th), np.zeros(n), -np.cos(th)], -1)
    out = native.integrate_batch(x0, d0, mass=0.0, r_capture=0.0,
                                 r_escape=40.0, lam_max=200.0)
    assert (out["status"] == states.ESCAPED).all()
    pf = out["p"] / np.linalg.norm(out["p"], axis=1, keepdims=True)
    np.testing.assert_allclose(pf, d0, atol=1e-12)
    # positions stay on the launch line
    t = (out["x"] - x0)
    cross = np.cross(t, d0)
    assert np.abs(cross).max() < 1e-9


def test_oracle_vs_jax_integrator_deflection():
    """The f32 fixed-step device path agrees with the f64 adaptive oracle on
    escape direction (the observable that sets every background pixel)."""
    n = 33
    b = np.linspace(2.75, 10.0, n)  # above the critical b = 3*sqrt(3)*M
    x0 = np.stack([b, np.zeros(n), np.full(n, 30.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))

    out = native.integrate_batch(x0, d0, mass=0.5, r_capture=1.0,
                                 r_escape=70.0, lam_max=300.0,
                                 rtol=1e-10, atol=1e-12)
    assert (out["status"] == states.ESCAPED).all()
    # escape direction = normalized coordinate velocity dx/dlam (matching
    # final_direction), not p: they differ by O(2M/r) at r_escape
    dir_oracle = np.stack([
        native.rhs(out["x"][i], out["p"][i],
                   native.null_init(x0[i], d0[i], 0.5, None)[1], 0.5,
                   None)[0]
        for i in range(n)])
    dir_oracle /= np.linalg.norm(dir_oracle, axis=1, keepdims=True)

    env = GeodesicEnv(mass=jnp.float32(0.5), r_capture=jnp.float32(1.0),
                      r_escape=jnp.float32(70.0), lam_max=jnp.float32(300.0))
    cfg = IntegratorConfig(n_steps=4096, dt=0.05, dt_boost=4.0,
                           backend="scan")
    s = launch(env, jnp.asarray(x0, jnp.float32),
               jnp.asarray(d0, jnp.float32), cfg)
    assert (np.asarray(s.status) == states.ESCAPED).all()
    dir_jax = np.asarray(final_direction(env, s))

    # angular agreement to a fraction of a 1024-pixel FOV (~1e-3 rad)
    cosang = np.clip(np.sum(dir_oracle * dir_jax, -1), -1, 1)
    assert np.arccos(cosang).max() < 2e-3


def test_oracle_termination_taxonomy():
    """Capture inside the photon-sphere impact parameter; inside-horizon
    start; budget exhaustion -- same taxonomy as ops/states.py."""
    M = 0.5
    bc = 3.0 * np.sqrt(3.0) * M  # critical impact parameter ~2.598
    hits = native.integrate_batch(
        np.asarray([[bc * 0.9, 0.0, 30.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=M, r_capture=2 * M, r_escape=70.0, lam_max=300.0)
    assert hits["status"][0] == states.CAPTURED
    misses = native.integrate_batch(
        np.asarray([[bc * 1.1, 0.0, 30.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=M, r_capture=2 * M, r_escape=70.0, lam_max=300.0)
    assert misses["status"][0] == states.ESCAPED

    inside = native.integrate_batch(
        np.asarray([[0.1, 0.0, 0.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=M, r_capture=2 * M, r_escape=70.0, lam_max=300.0)
    assert inside["status"][0] == states.INSIDE_HORIZON

    budget = native.integrate_batch(
        np.asarray([[10.0, 0.0, 30.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=M, r_capture=2 * M, r_escape=70.0, lam_max=1.0)
    assert budget["status"][0] == states.BUDGET


def test_oracle_disk_and_sphere_events():
    M = 0.5
    # ray through the z=0 annulus
    out = native.integrate_batch(
        np.asarray([[4.0, 0.0, 20.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=M, r_capture=2 * M, r_escape=70.0, lam_max=300.0,
        disk=(2.0, 6.0))
    assert out["status"][0] == states.DISK
    assert abs(out["x"][0, 2]) < 1e-9  # frozen exactly on the plane
    rr = np.hypot(out["x"][0, 0], out["x"][0, 1])
    assert 2.0 <= rr <= 6.0

    # ray at a sphere
    out = native.integrate_batch(
        np.asarray([[0.0, 0.0, 20.0]]), np.asarray([[0.0, 0.0, -1.0]]),
        mass=0.0, r_capture=0.0, r_escape=70.0, lam_max=300.0,
        spheres=np.asarray([[0.0, 0.0, -10.0, 2.0]]))
    assert out["status"][0] == states.OBJECT
    assert out["hit_obj"][0] == 0
    np.testing.assert_allclose(out["x"][0], [0.0, 0.0, -8.0], atol=1e-9)


def test_oracle_hamiltonian_conservation():
    """Along the adaptive trajectory Hh stays ~0 at f64 tolerance."""
    tx, tp, tl, st, _ = native.trajectory(
        [2.8, 0.0, 30.0], [0.0, 0.0, -1.0], mass=0.5, r_capture=1.0,
        r_escape=70.0, lam_max=300.0, rtol=1e-10, atol=1e-12)
    assert st == states.ESCAPED
    _, E = native.null_init([2.8, 0.0, 30.0], [0.0, 0.0, -1.0], 0.5, None)
    hh = [float(g.hamiltonian(jnp.asarray(tx[i], jnp.float64)
                              if False else jnp.asarray(tx[i], jnp.float32),
                              jnp.asarray(tp[i], jnp.float32),
                              jnp.float32(E), 0.5, None))
          for i in range(0, tx.shape[0], max(1, tx.shape[0] // 16))]
    assert max(abs(v) for v in hh) < 5e-5  # f32 eval of f64 states


def test_compat_native_backend():
    """calc_trajectory(backend='native') serves the reference contract."""
    from blackhole_geodesic_calculator_tpu.compat import (
        GeodesicIntegratorSchwarzschild,
    )

    gi = GeodesicIntegratorSchwarzschild(mass=0.5, backend="native")
    k, x, res = gi.calc_trajectory([0.0, 0.0, -1.0], [2.0, 0.0, 30.0],
                                   max_step=0.1, curve_end=300.0)
    assert res["hit_blackhole"]  # b=2 < critical 2.598
    assert x.shape[0] == 3 and x.shape[1] > 10
    gj = GeodesicIntegratorSchwarzschild(mass=0.5)
    _, _, res_j = gj.calc_trajectory([0.0, 0.0, -1.0], [2.0, 0.0, 30.0],
                                     max_step=0.05, curve_end=300.0)
    assert bool(res_j["hit_blackhole"]) == bool(res["hit_blackhole"])


def test_png_roundtrip(tmp_path, rng):
    for c in (3, 4):
        img = (rng.random((37, 53, c)) * 255).astype(np.uint8)
        p = str(tmp_path / f"t{c}.png")
        native.write_png(p, img)
        back = native.read_png(p)
        assert np.array_equal(img, back)


def test_pfm_roundtrip(tmp_path, rng):
    img = rng.random((21, 17, 3)).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    native.write_pfm(p, img)
    assert np.array_equal(img, native.read_pfm(p))


def test_frame_writer(tmp_path):
    frames = [np.full((16, 24, 3), i / 8.0, np.float32) for i in range(8)]
    with native.FrameWriter(threads=3) as fw:
        for i, fr in enumerate(frames):
            fw.submit(str(tmp_path / f"f{i}.png"), fr)
    for i in range(8):
        back = native.read_png(str(tmp_path / f"f{i}.png"))
        expect = np.uint8(np.float32(i / 8.0) * 255 + 0.5)
        assert (back == expect).all()


def test_write_png_io_integration(tmp_path, rng):
    """io_.write_png routes through the native encoder and read_image
    decodes it (PIL-free roundtrip)."""
    from blackhole_geodesic_calculator_tpu.io_ import write_png
    from blackhole_geodesic_calculator_tpu.io_.image import read_image

    img = rng.random((19, 29, 3)).astype(np.float32)
    p = str(tmp_path / "r.png")
    write_png(p, img)
    back = read_image(p)
    assert back.shape == (19, 29, 3)
    assert np.abs(back - np.clip(img, 0, 1)).max() < 1.0 / 255 + 1e-6


def test_bench_schedule_accuracy():
    """The bench.py step schedule (n=100, dt=0.12, boost=64, r_ref=1.7,
    power=1.5) must stay sub-pixel-accurate against the f64 oracle: worst
    escape direction error < 7.8e-4 rad (one pixel of the 1024px/0.8rad
    flagship camera), every ray finished, capture set identical.  The fan
    spans b in [2, 15] -- past the flagship camera's corner rays (b ~ 12.3)
    -- with dense coverage of the near-critical band around
    b_c = 3 sqrt(3) M ~ 2.598 where the error is sharpest."""
    n = 97
    b = np.concatenate([np.linspace(2.0, 3.5, 49), np.linspace(3.6, 15.0, n - 49)])
    x0 = np.stack([b, np.zeros(n), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    oracle = native.integrate_batch(x0, d0, mass=0.5, r_capture=1.0,
                                    r_escape=70.0, lam_max=100.0,
                                    rtol=1e-11, atol=1e-13)

    env = GeodesicEnv(mass=jnp.float32(0.5), r_capture=jnp.float32(1.0),
                      r_escape=jnp.float32(70.0), lam_max=jnp.float32(100.0))
    cfg = IntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                           dt_boost_r_ref=1.7, dt_power=1.5)
    s = launch(env, jnp.asarray(x0, jnp.float32),
               jnp.asarray(d0, jnp.float32), cfg)
    st = np.asarray(s.status)
    assert (st != states.ACTIVE).all(), "rays left unfinished"
    cap = st == states.CAPTURED
    cap_o = oracle["status"] == states.CAPTURED
    assert (cap == cap_o).all(), "capture set disagrees with oracle"

    esc = (st == states.ESCAPED) & (oracle["status"] == states.ESCAPED)
    d_jax = np.asarray(final_direction(env, s))[esc]
    d_o = np.stack([
        native.rhs(oracle["x"][i], oracle["p"][i],
                   native.null_init(x0[i], d0[i], 0.5, None)[1], 0.5,
                   None)[0]
        for i in range(n)])[esc]
    d_o /= np.linalg.norm(d_o, axis=1, keepdims=True)
    ang = np.arccos(np.clip(np.sum(d_jax * d_o, -1), -1, 1))
    assert ang.max() < 7.8e-4, f"worst deflection err {ang.max():.2e} rad"


def test_adaptive_jax_vs_native_oracle():
    """The two adaptive Dormand-Prince implementations -- the JAX
    lax.while_loop one (ops/integrate.integrate_adaptive) and the C++ f64
    oracle (native/src/geodesic.cpp) -- must agree on escape directions and
    step economy for the same tolerances."""
    from blackhole_geodesic_calculator_tpu.ops.integrate import (
        integrate_adaptive,
    )
    from blackhole_geodesic_calculator_tpu.ops.geodesic import (
        null_init, xdot,
    )
    from blackhole_geodesic_calculator_tpu.ops.states import init_state

    n = 17
    b = np.linspace(2.8, 9.0, n)
    x0 = np.stack([b, np.zeros(n), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))

    out = native.integrate_batch(x0, d0, mass=0.5, r_capture=1.0,
                                 r_escape=60.0, lam_max=200.0,
                                 rtol=1e-9, atol=1e-11)
    assert (out["status"] == states.ESCAPED).all()
    d_o = np.stack([
        native.rhs(out["x"][i], out["p"][i],
                   native.null_init(x0[i], d0[i], 0.5, None)[1], 0.5,
                   None)[0] for i in range(n)])
    d_o /= np.linalg.norm(d_o, axis=1, keepdims=True)

    env = GeodesicEnv(mass=jnp.float32(0.5), r_capture=jnp.float32(1.0),
                      r_escape=jnp.float32(60.0), lam_max=jnp.float32(200.0))
    x0j = jnp.asarray(x0, jnp.float32)
    d0j = jnp.asarray(d0, jnp.float32)
    p, E = null_init(x0j, d0j, env.mass, None)
    s0 = init_state(x0j, p, E)
    cfg = IntegratorConfig(n_steps=20000, dt=0.05, method="dopri",
                           rtol=1e-6, atol=1e-8)
    s, n_acc = integrate_adaptive(env, s0, cfg)
    assert (np.asarray(s.status) == states.ESCAPED).all()
    v = xdot(s.x, s.p, s.E, env.mass, None)
    d_j = np.asarray(v / jnp.linalg.norm(v, axis=-1, keepdims=True))
    ang = np.arccos(np.clip(np.sum(d_j * d_o, -1), -1, 1))
    assert ang.max() < 1e-3, f"adaptive paths disagree: {ang.max():.2e} rad"
    # both adaptive steppers should use the same order of magnitude of
    # accepted steps (f32 path runs looser tolerances, so <= ~4x apart)
    mean_native = out["n_steps"].mean()
    assert float(np.asarray(n_acc).mean()) <= 4 * mean_native + 50


def test_frame_writer_u8_path(tmp_path):
    """uint8 frames (device-quantized, 4x smaller transfer) are encoded
    as-is by the async writer and round-trip exactly; srgb on a u8 frame
    is rejected (it must be pre-applied on device)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (12, 16, 4), dtype=np.uint8)
    with native.FrameWriter(threads=2) as fw:
        fw.submit(str(tmp_path / "u8.png"), img)
    back = native.read_png(str(tmp_path / "u8.png"))
    assert np.array_equal(back, img)
    with native.FrameWriter(threads=1) as fw:
        import pytest as _pytest

        with _pytest.raises(ValueError):
            fw.submit(str(tmp_path / "x.png"), img, srgb=True)


def test_render_image_u8_matches_host_quantize():
    """render_image_u8 == host-side quantization of render_image (same
    clip/scale/round as io_.write_png), tonemap included."""
    import dataclasses

    import jax.numpy as jnp

    from blackhole_geodesic_calculator_tpu.camera import Camera
    from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig
    from blackhole_geodesic_calculator_tpu.render import (
        RenderConfig, render_image, render_image_u8,
    )
    from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene

    h, w = 16, 32
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = jnp.asarray(np.stack(
        [2.0 * ((u // 4 + v // 4) % 2), v / h, 0.4 + 0 * u], -1),
        jnp.float32)  # >1 values exercise the clip and the tonemap
    scene = Scene(bh=BlackHole.make(mass=0.5), background=sky)
    cam = Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7))
    cfg = RenderConfig(width=24, height=16,
                       integrator=IntegratorConfig(n_steps=60, dt=0.2,
                                                   dt_boost=16.0,
                                                   dt_boost_r_ref=1.6),
                       lam_max=50.0)
    ref = np.asarray(render_image(scene, cam, cfg))

    u8 = np.asarray(render_image_u8(scene, cam, cfg))
    host = (np.clip(ref, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(u8, host)

    u8t = np.asarray(render_image_u8(scene, cam, cfg, tonemap=True))
    rgb = ref[..., :3]
    tm = rgb / (1.0 + rgb)
    host_t = (np.clip(np.concatenate([tm, ref[..., 3:]], -1), 0.0, 1.0)
              * 255.0 + 0.5).astype(np.uint8)
    # device vs host float rounding can land on a quantization boundary
    assert np.abs(u8t.astype(int) - host_t.astype(int)).max() <= 1


def test_trajectory_batch_matches_per_ray():
    """The multithreaded batch trajectory API (one FFI crossing, rays
    solved in parallel C++ threads) must be BIT-IDENTICAL to N calls of
    the per-ray `trajectory` (same integrate_one core) and must back the
    compat native path without the old per-ray Python loop."""
    from blackhole_geodesic_calculator_tpu import native

    if not native.available():
        pytest.skip("native library unavailable")

    kw = dict(mass=0.5, r_capture=1.0, r_escape=70.0, lam_max=120.0,
              max_step=0.1)
    x0 = np.asarray([[0.0, 5.0, 30.0], [0.0, 2.0, 30.0],
                     [0.0, 0.5, 30.0], [3.0, -4.0, 30.0]])
    d0 = np.tile([0.0, 0.0, -1.0], (4, 1))
    out = native.trajectory_batch(x0, d0, max_points=4000, **kw)
    for i in range(4):
        tx, tp, tl, st, _ = native.trajectory(x0[i], d0[i],
                                              max_points=4000, **kw)
        n = out["n_points"][i]
        assert n == len(tx)
        assert st == out["status"][i]
        np.testing.assert_array_equal(out["traj_x"][i, :n], tx)
        np.testing.assert_array_equal(out["traj_lam"][i, :n], tl)
        _, E = native.null_init(x0[i], d0[i], 0.5, None)
        assert abs(out["E"][i] - E) == 0.0
        v, _ = native.rhs_batch(tx, tp, E, 0.5, None)
        np.testing.assert_array_equal(out["traj_v"][i, :n], v)
    # statuses span escape and capture in this fan
    assert set(out["status"].tolist()) >= {1, 2}


def test_trajectory_batch_kerr_compat_path():
    """compat.calc_trajectory(backend='native') on a batch goes through
    trajectory_batch; spot-check Kerr flags and shapes."""
    from blackhole_geodesic_calculator_tpu.compat import (
        GeodesicIntegratorSchwarzschild,
    )

    gi = GeodesicIntegratorSchwarzschild(mass=0.5, spin=0.45,
                                     backend="native")
    x0 = [[2.0, 0.0, 30.0], [8.0, 0.0, 30.0]]
    d0 = [[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]
    k, x, res = gi.calc_trajectory(d0, x0, max_step=0.1, curve_end=300.0)
    assert isinstance(x, list) and len(x) == 2
    assert x[0].shape[0] == 3
    assert bool(res["hit_blackhole"][0]) and not bool(res["hit_blackhole"][1])
    assert np.isfinite(res["end_dir"]).all()
