"""Learned (MLP) scattering-map surrogate: models/surrogate.py.

The reference planned this as "a Tensorflow model or interpolation"
(/root/reference/README.md:237) and shipped neither; its table-based
interpolation stand-in only exists for Schwarzschild where spherical
symmetry makes it exact.  These tests cover the neural Kerr-capable path:
exact symmetry equivariance (architectural, not learned), training
convergence against the live integrator, persistence, and the drop-in
``trace`` protocol with the Gen-1 hybrid renderer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blackhole_geodesic_calculator_tpu.models.surrogate import (
    NeuralSurrogate,
    SurrogateConfig,
    canonicalize,
    evaluate_surrogate,
    init_params,
    label_rays,
    load_surrogate,
    sample_entries,
    save_surrogate,
    train_surrogate,
    _label_env,
    _rz,
)
from blackhole_geodesic_calculator_tpu.ops import states


def _random_surrogate(key, cfg, mass=0.5, spin=0.45):
    return NeuralSurrogate(
        params=init_params(key, cfg),
        mass=jnp.asarray(mass, jnp.float32),
        spin=jnp.asarray(spin, jnp.float32),
        r_influence=jnp.asarray(cfg.r_influence, jnp.float32),
    )


def _entries(key, n, R):
    k1, k2 = jax.random.split(key)
    e = jax.random.normal(k1, (n, 3), jnp.float32)
    e = R * e / jnp.linalg.norm(e, axis=-1, keepdims=True)
    d = jax.random.normal(k2, (n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    # point inward-ish so the scattering frame is generic
    s = jnp.sign(jnp.sum(d * (-e / R), axis=-1, keepdims=True))
    return e, d * jnp.where(s == 0, 1.0, s)


class TestSymmetry:
    """Equivariance is canonicalized in, so it must hold EXACTLY (up to
    float round-off) for ANY parameters, trained or not — the closed-form
    Kerr-Schild symmetries: axisymmetry about the spin axis and equatorial
    reflection (models/kerr.py docstring)."""

    def test_rotation_equivariance(self):
        cfg = SurrogateConfig(width=32, depth=2)
        sur = _random_surrogate(jax.random.PRNGKey(0), cfg)
        e, d = _entries(jax.random.PRNGKey(1), 64, cfg.r_influence)
        phi = 1.234
        rot = np.asarray(_rz(jnp.asarray(phi)))
        loc0, dir0, cap0 = sur.trace(e, d)
        loc1, dir1, cap1 = sur.trace(e @ rot.T, d @ rot.T)
        np.testing.assert_allclose(np.asarray(loc1), np.asarray(loc0) @ rot.T,
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(dir1), np.asarray(dir0) @ rot.T,
                                   atol=2e-4)
        np.testing.assert_array_equal(np.asarray(cap1), np.asarray(cap0))

    def test_reflection_equivariance(self):
        cfg = SurrogateConfig(width=32, depth=2)
        sur = _random_surrogate(jax.random.PRNGKey(0), cfg)
        e, d = _entries(jax.random.PRNGKey(2), 64, cfg.r_influence)
        flip = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
        loc0, dir0, cap0 = sur.trace(e, d)
        loc1, dir1, cap1 = sur.trace(e @ flip, d @ flip)
        np.testing.assert_allclose(np.asarray(loc1), np.asarray(loc0) @ flip,
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(dir1), np.asarray(dir0) @ flip,
                                   atol=2e-4)
        np.testing.assert_array_equal(np.asarray(cap1), np.asarray(cap0))

    def test_canonical_frame(self):
        e, d = _entries(jax.random.PRNGKey(3), 128, 20.0)
        ec, dc, phi, flip = canonicalize(e, d)
        np.testing.assert_allclose(np.asarray(ec[:, 1]), 0.0, atol=1e-4)
        assert bool(jnp.all(ec[:, 2] >= -1e-5))
        # norm-preserving
        np.testing.assert_allclose(np.asarray(jnp.linalg.norm(dc, axis=-1)),
                                   1.0, atol=1e-5)


class TestSampler:
    def test_entries_on_sphere_inward(self):
        cfg = SurrogateConfig(r_influence=15.0)
        e, d = sample_entries(jax.random.PRNGKey(0), 512, cfg, 0.5)
        np.testing.assert_allclose(np.asarray(jnp.linalg.norm(e, axis=-1)),
                                   15.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(jnp.linalg.norm(d, axis=-1)),
                                   1.0, atol=1e-5)
        assert bool(jnp.all(jnp.sum(d * (-e), axis=-1) >= -1e-3))

    def test_labels_cover_both_classes(self):
        """The mixed impact-parameter sampler must produce a usefully
        balanced capture/escape split (a uniform sampler gives ~2%
        captured — the class-starvation problem the docstring states)."""
        cfg = SurrogateConfig(r_influence=10.0, n_steps=256, dt=0.1,
                              lam_max=80.0, backend="scan")
        env = _label_env(0.5, None, cfg)
        e, d = sample_entries(jax.random.PRNGKey(1), 512, cfg, 0.5)
        captured, _, _, escaped = label_rays(env, cfg, e, d)
        frac = float(jnp.mean(captured.astype(jnp.float32)))
        assert 0.1 < frac < 0.6
        assert float(jnp.mean(escaped.astype(jnp.float32))) > 0.3


class TestTraining:
    def test_train_schwarzschild_smoke(self):
        """Small end-to-end training run against the live integrator on the
        CPU mesh: loss must drop and held-out capture accuracy must beat
        the class prior by a wide margin."""
        cfg = SurrogateConfig(width=64, depth=3, r_influence=10.0,
                              n_steps=200, dt=0.1, lam_max=80.0,
                              backend="scan")
        sur, hist = train_surrogate(
            jax.random.PRNGKey(0), mass=0.5, spin=None, cfg=cfg,
            steps=200, batch=512, lr=3e-3, log_every=40)
        assert hist["loss"][-1] < 0.6 * hist["loss"][0]
        m = evaluate_surrogate(jax.random.PRNGKey(7), sur, cfg, n=2048)
        assert m["capture_acc"] > 0.9
        # escaped rays dominated by weak deflection: the direction
        # regression must be meaningfully learned, not random (pi/2)
        assert m["dir_err_median_rad"] < 0.5

    def test_kerr_labeling_path(self):
        """Kerr labels run through the spin branch of the integrator and
        produce the same taxonomy."""
        cfg = SurrogateConfig(r_influence=10.0, n_steps=256, dt=0.1,
                              lam_max=80.0, backend="scan")
        env = _label_env(0.5, 0.45, cfg)
        e, d = sample_entries(jax.random.PRNGKey(4), 256, cfg, 0.5)
        captured, exit_loc, exit_dir, escaped = label_rays(env, cfg, e, d)
        assert bool(jnp.any(captured)) and bool(jnp.any(escaped))
        r_exit = jnp.linalg.norm(exit_loc, axis=-1)
        assert bool(jnp.all(r_exit[escaped] > 10.0 * 0.99))
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(exit_dir[escaped], axis=-1)), 1.0,
            atol=1e-4)


class TestPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        cfg = SurrogateConfig(width=32, depth=2)
        sur = _random_surrogate(jax.random.PRNGKey(5), cfg, spin=0.3)
        path = tmp_path / "sur.npz"
        save_surrogate(path, sur)
        sur2 = load_surrogate(path)
        e, d = _entries(jax.random.PRNGKey(6), 32, cfg.r_influence)
        a = sur.trace(e, d)
        b = sur2.trace(e, d)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert float(sur2.spin) == pytest.approx(0.3)


class TestCompatProtocol:
    def test_approx_kerr_generated_ray_tracer(self, tmp_path):
        """compat.ApproxKerrGeodesic mirrors the reference surrogate call
        ``aSW.generatedRayTracer(loc_hit, direction)``
        (LimitedRelativisticRenderEngine.py:269) for a spinning hole, with
        npz persistence standing in for the reference's reload semantics
        (:96-101)."""
        from blackhole_geodesic_calculator_tpu.compat import (
            ApproxKerrGeodesic)

        path = tmp_path / "kerr_sur.npz"
        ak = ApproxKerrGeodesic(
            ratio_obj_to_blackhole=10.0, mass=0.5, a=0.45,
            train_steps=40, batch=256, width=32, depth=2,
            save_path=path)
        # single-ray protocol
        end_loc, end_dir, mes = ak.generatedRayTracer(
            [-10.0, 1.0, 0.5], [1.0, 0.0, 0.0])
        assert end_loc.shape == (3,) and end_dir.shape == (3,)
        assert set(mes) == {"hit_blackhole", "start_inside_hole"}
        # batched protocol + load path reproduces the saved model
        ak2 = ApproxKerrGeodesic(ratio_obj_to_blackhole=10.0, mass=0.5,
                                 a=0.45, load_path=path)
        el2, ed2, _ = ak2.generatedRayTracer(
            np.asarray([[-10.0, 1.0, 0.5]]), np.asarray([[1.0, 0.0, 0.0]]))
        np.testing.assert_allclose(el2[0], end_loc, atol=1e-6)
        np.testing.assert_allclose(ed2[0], end_dir, atol=1e-6)


class TestRendererIntegration:
    def test_limited_render_accepts_neural_surrogate(self):
        """NeuralSurrogate satisfies SurrogateTable's trace protocol: the
        Gen-1 hybrid renderer runs with it as the approx backend
        (reference approx mode, LimitedRelativisticRenderEngine.py:269)."""
        from blackhole_geodesic_calculator_tpu.camera import Camera
        from blackhole_geodesic_calculator_tpu.render import (
            LimitedConfig, RenderConfig, render_limited)
        from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene

        cfg = SurrogateConfig(width=32, depth=2, r_influence=10.0)
        sur = _random_surrogate(jax.random.PRNGKey(8), cfg, spin=0.0)
        sky = jnp.ones((8, 16, 3), jnp.float32) * 0.5
        scene = Scene(bh=BlackHole.make(mass=0.5), background=sky)
        rcfg = RenderConfig(width=24, height=24, samples=1)
        lcfg = LimitedConfig(approx=True, r_influence=cfg.r_influence)
        cam = Camera.make(position=(0.0, 0.0, 40.0), fov=(0.6, 0.6))
        img = render_limited(scene, cam, rcfg, lcfg, table=sur)
        assert img.shape == (24, 24, 4)
        assert bool(jnp.all(jnp.isfinite(img)))

    def test_kerr_approx_requires_learned_surrogate(self):
        """approx=True on a spinning scene without a table must refuse (a
        Schwarzschild symmetry table would silently drop the spin)."""
        import dataclasses

        from blackhole_geodesic_calculator_tpu.camera import Camera
        from blackhole_geodesic_calculator_tpu.render import (
            LimitedConfig, RenderConfig, render_limited)
        from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene

        scene = Scene(bh=BlackHole.make(mass=0.5, spin=0.3),
                      background=jnp.ones((8, 16, 3)) * 0.5)
        with pytest.raises(ValueError, match="learned surrogate"):
            render_limited(scene, Camera.make(position=(0.0, 0.0, 40.0)),
                           RenderConfig(width=8, height=8),
                           LimitedConfig(approx=True))

    def test_kerr_limited_render_with_trained_surrogate(self):
        """End-to-end Kerr hybrid render through a (briefly) trained
        NeuralSurrogate: the learned path renders a spinning-hole scene the
        table never could."""
        from blackhole_geodesic_calculator_tpu.camera import Camera
        from blackhole_geodesic_calculator_tpu.render import (
            LimitedConfig, RenderConfig, render_limited)
        from blackhole_geodesic_calculator_tpu.scene import BlackHole, Scene

        cfg = SurrogateConfig(width=32, depth=2, r_influence=10.0,
                              n_steps=160, dt=0.12, lam_max=80.0,
                              backend="scan")
        sur, _ = train_surrogate(jax.random.PRNGKey(0), mass=0.5, spin=0.45,
                                 cfg=cfg, steps=60, batch=256)
        scene = Scene(bh=BlackHole.make(mass=0.5, spin=0.45),
                      background=jnp.ones((8, 16, 3)) * 0.5)
        img = render_limited(
            scene, Camera.make(position=(0.0, 0.0, 40.0), fov=(0.6, 0.6)),
            RenderConfig(width=16, height=16),
            LimitedConfig(approx=True, r_influence=10.0), table=sur)
        assert img.shape == (16, 16, 4)
        assert bool(jnp.all(jnp.isfinite(img)))


class TestPrecision:
    def test_f32_vs_bf16_paths_close_not_identical(self):
        """The precision field selects the matmul path: f32 (accurate default)
        and bf16 (preview) must agree to bf16 rounding but differ in bits
        (proving both paths are real), and the static field must re-trace
        under jit."""
        cfg = SurrogateConfig(width=32, depth=2)
        sur = _random_surrogate(jax.random.PRNGKey(3), cfg)
        e, d = _entries(jax.random.PRNGKey(4), 256, cfg.r_influence)
        lo_f, do_f, cap_f = jax.jit(sur.trace)(e, d)
        sur_b = dataclasses.replace(sur, precision="bf16")
        lo_b, do_b, cap_b = jax.jit(sur_b.trace)(e, d)
        # close: bf16 rounding class
        assert float(jnp.abs(do_f - do_b).max()) < 0.1
        # not identical: the paths genuinely differ
        assert float(jnp.abs(lo_f - lo_b).max()) > 0.0
        # capture decisions agree except at logit boundaries
        assert float(jnp.mean((cap_f == cap_b).astype(jnp.float32))) > 0.95

    def test_equivariance_holds_in_bf16(self):
        """Symmetry canonicalization is outside the network, so both
        precision paths are exactly Rz-equivariant."""
        cfg = SurrogateConfig(width=32, depth=2)
        sur = dataclasses.replace(
            _random_surrogate(jax.random.PRNGKey(5), cfg),
            precision="bf16")
        e, d = _entries(jax.random.PRNGKey(6), 64, cfg.r_influence)
        phi = 1.234
        rot = np.asarray(_rz(jnp.asarray(phi)))
        lo, do_, cap = sur.trace(e, d)
        lo2, do2, cap2 = sur.trace(e @ rot.T, d @ rot.T)
        np.testing.assert_allclose(np.asarray(lo2), np.asarray(lo) @ rot.T,
                                   atol=2e-3)
        np.testing.assert_array_equal(np.asarray(cap), np.asarray(cap2))
