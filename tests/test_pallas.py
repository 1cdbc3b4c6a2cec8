"""RK4 kernel tests: parity, adjoint, dispatch, padding (interpret mode on CPU).

The fused kernel (ops/pallas_kernel.py) must agree with the XLA scan path
(ops/integrate.py) -- forward states close and gradients matching the scan
path's autodiff, since the scan path is the reference implementation whose
own gradients are FD-validated in test_grad.py.  The kernel's Triton
lowering is checked here too, by lowering it for CUDA on the CPU host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blackhole_geodesic_calculator_tpu.ops import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    SphereGeom,
    launch,
    states,
)
from blackhole_geodesic_calculator_tpu.ops import pallas_kernel as pk
from blackhole_geodesic_calculator_tpu.ops.geodesic import null_init
from blackhole_geodesic_calculator_tpu.ops.integrate import (
    _segments, _use_pallas, integrate, integrate_fixed)
from blackhole_geodesic_calculator_tpu.ops.pallas_kernel import integrate_pallas

CFG = IntegratorConfig(n_steps=64, dt=0.1)


def rays(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(x0), jnp.asarray(d, jnp.float32)


def make_env(mass, center=(2.0, 0.0, 10.0), radius=3.0):
    return GeodesicEnv(
        mass=mass, r_capture=2.0 * mass,
        r_escape=jnp.asarray(60.0), lam_max=jnp.asarray(50.0),
        disk=DiskGeom(r_in=jnp.asarray(2.0), r_out=jnp.asarray(6.0)),
        spheres=SphereGeom(center=jnp.asarray([center]),
                           radius=jnp.asarray([radius])),
    )


def initial(env, x0, d0):
    p0, E0 = null_init(x0, d0, env.mass, env.spin)
    return states.init_state(x0, p0, E0)


def pallas_launch(env, x0, d0, cfg, **kw):
    return integrate_pallas(env, initial(env, x0, d0), cfg, interpret=True,
                            **kw)


def assert_same_state(ref, out, atol=2e-5):
    np.testing.assert_array_equal(np.asarray(ref.status),
                                  np.asarray(out.status))
    np.testing.assert_array_equal(np.asarray(ref.hit_obj),
                                  np.asarray(out.hit_obj))
    np.testing.assert_allclose(np.asarray(ref.x), np.asarray(out.x),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(ref.p), np.asarray(out.p),
                               atol=atol)
    np.testing.assert_allclose(np.asarray(ref.lam), np.asarray(out.lam),
                               atol=1e-4)


def test_forward_parity():
    """Statuses identical, states f32-close, padding handled (N=1500)."""
    env = make_env(jnp.asarray(0.5))
    x0, d0 = rays()
    s_ref = launch(env, x0, d0, CFG)
    s_pal = pallas_launch(env, x0, d0, CFG)
    assert_same_state(s_ref, s_pal)


def test_adjoint_matches_scan_autodiff():
    """The kernel's custom_vjp (XLA vjp of the checkpointed segments)
    reproduces the scan path's gradients w.r.t. mass, sphere center, ray
    origins and directions."""
    x0, d0 = rays(1024, seed=1)
    rng = np.random.default_rng(2)
    wx = jnp.asarray(rng.normal(size=(1024, 3)), jnp.float32)

    def loss(mass, cz, x0_, d0_, *, pallas):
        env = make_env(mass, center=(2.0, 0.0, cz))
        s0 = initial(env, x0_, d0_)
        if pallas:
            s = integrate_pallas(env, s0, CFG, interpret=True)
        else:
            s = integrate_fixed(env, s0, CFG)
        ok = ((s.status != states.CAPTURED)
              & (s.status != states.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, wx * s.x, 0.0))

    args = (jnp.asarray(0.5), jnp.asarray(10.0), x0, d0)
    g_ref = jax.grad(lambda *a: loss(*a, pallas=False), argnums=(0, 1, 2, 3))(*args)
    g_pal = jax.grad(lambda *a: loss(*a, pallas=True), argnums=(0, 1, 2, 3))(*args)
    for a, b in zip(g_ref, g_pal):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(a).max(), 1.0))


def test_no_nan_gradients_with_all_event_types():
    """Rays spanning capture/escape/disk/sphere/budget must yield finite
    gradients through both paths (regression for the 0*inf NaN-jacobian
    traps)."""
    x0, d0 = rays(512, seed=3)

    def loss(mass, pallas):
        env = make_env(mass)
        s0 = initial(env, x0, d0)
        s = (integrate_pallas(env, s0, CFG, interpret=True) if pallas
             else integrate_fixed(env, s0, CFG))
        ok = ((s.status != states.CAPTURED)
              & (s.status != states.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, s.x**2, 0.0))

    for pallas in (False, True):
        g = jax.grad(loss)(jnp.asarray(0.5), pallas)
        assert np.isfinite(float(g))


def test_kerr_forward_parity_and_adjoint():
    """Kerr (a != 0) goes through the same kernel with the hand-derived
    analytic Kerr-Schild RHS (pallas_kernel._rhs_kerr_soa, the component
    twin of native/src/geodesic.cpp); forward states and (mass, spin)
    gradients must match the XLA path.  n_steps=50 is NOT a segment
    multiple, so the checkpoint tail segment is exercised too."""
    from blackhole_geodesic_calculator_tpu.models.kerr import horizon_radius

    x0, d0 = rays(1024, seed=5)
    rng = np.random.default_rng(6)
    wx = jnp.asarray(rng.normal(size=(1024, 3)), jnp.float32)
    m, a = jnp.asarray(0.5), jnp.asarray(0.45)
    cfg = dataclasses.replace(CFG, n_steps=50)

    def env_of(mm, aa):
        return GeodesicEnv(
            mass=mm, spin=aa, r_capture=horizon_radius(mm, aa),
            r_escape=jnp.asarray(60.0), lam_max=jnp.asarray(50.0),
            disk=DiskGeom(r_in=jnp.asarray(2.0), r_out=jnp.asarray(6.0)))

    env = env_of(m, a)
    assert_same_state(integrate_fixed(env, initial(env, x0, d0), cfg),
                      pallas_launch(env, x0, d0, cfg), atol=5e-5)

    def loss(mm, aa, pallas):
        e = env_of(mm, aa)
        s0 = initial(e, x0, d0)
        s = (integrate_pallas(e, s0, cfg, interpret=True) if pallas
             else integrate_fixed(e, s0, cfg))
        ok = ((s.status != states.CAPTURED)
              & (s.status != states.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, wx * s.x, 0.0))

    g_ref = jax.grad(lambda *a_: loss(*a_, pallas=False), argnums=(0, 1))(m, a)
    g_pal = jax.grad(lambda *a_: loss(*a_, pallas=True), argnums=(0, 1))(m, a)
    for r, p in zip(g_ref, g_pal):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=2e-4)


def test_forward_parity_guard_stress():
    """Sphere-guard stress: spheres placed where the conservative
    radius-shell test is tightest -- deep in the strong field (photon-
    sphere radii, where step segments are short) and far out (where the
    r^1.5 schedule makes L large) -- plus a Kerr case exercising the
    |a|-widened band.  Statuses/hit ids must match the XLA path exactly
    (a mis-culled sphere test would flip OBJECT statuses)."""
    x0, d0 = rays(n=1200, seed=7)
    for spin, centers, radii in (
            (None, [[0.0, 2.6, 0.0], [0.0, 0.0, 30.0]], [0.7, 2.0]),
            (0.45, [[2.0, 0.0, 0.3], [-6.0, 6.0, 0.0]], [0.8, 1.0]),
    ):
        env = GeodesicEnv(
            mass=jnp.asarray(0.5), r_capture=jnp.asarray(1.0),
            r_escape=jnp.asarray(60.0), lam_max=jnp.asarray(60.0),
            spin=None if spin is None else jnp.asarray(spin),
            spheres=SphereGeom(center=jnp.asarray(centers),
                               radius=jnp.asarray(radii)))
        cfg = dataclasses.replace(CFG, dt_boost=64.0, dt_power=1.5,
                                  dt_boost_r_ref=1.7)
        s_ref = launch(env, x0, d0, cfg)
        s_pal = pallas_launch(env, x0, d0, cfg)
        np.testing.assert_array_equal(np.asarray(s_ref.status),
                                      np.asarray(s_pal.status))
        np.testing.assert_array_equal(np.asarray(s_ref.hit_obj),
                                      np.asarray(s_pal.hit_obj))
        assert int(np.sum(np.asarray(s_ref.status) == states.OBJECT)) >= 2


# =============================================================================
# Dispatch, wrapper shapes, padding and block choice.
# =============================================================================
def test_dispatch_auto_on_cpu_picks_xla():
    """backend='auto' serves the XLA scan off the GPU (no kernel, no
    interpret mode): integrate() equals integrate_fixed bit for bit."""
    assert jax.default_backend() == "cpu"
    assert not _use_pallas(CFG)
    assert not _use_pallas(dataclasses.replace(CFG, backend="scan"))
    assert not _use_pallas(dataclasses.replace(CFG, method="dopri"))
    env = make_env(jnp.asarray(0.5))
    s0 = initial(env, *rays(64))
    a, b = integrate(env, s0, CFG), integrate_fixed(env, s0, CFG)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    jaxpr = str(jax.make_jaxpr(lambda s: integrate(env, s, CFG))(s0))
    assert "pallas_call" not in jaxpr


def test_pallas_backend_without_gpu_raises():
    """backend='pallas' demands the kernel: off the GPU it raises instead of
    falling back; there is no Dormand-Prince kernel; unknown names raise."""
    env = make_env(jnp.asarray(0.5))
    s0 = initial(env, *rays(8))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        integrate(env, s0, dataclasses.replace(CFG, backend="pallas"))
    with pytest.raises(ValueError, match="rk4"):
        integrate(env, s0, dataclasses.replace(CFG, backend="pallas",
                                               method="dopri"))
    with pytest.raises(ValueError, match="backend"):
        integrate(env, s0, dataclasses.replace(CFG, backend="mosaic"))


def _grid(fn, *args):
    """The grid of the (single) pallas_call in fn's jaxpr."""
    found = []

    def walk(v):
        if hasattr(v, "eqns"):
            for eqn in v.eqns:
                if eqn.primitive.name == "pallas_call":
                    found.append(eqn.params["grid_mapping"].grid)
                for p in eqn.params.values():
                    walk(p)
        elif hasattr(v, "jaxpr"):
            walk(v.jaxpr)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)

    walk(jax.make_jaxpr(fn)(*args))
    assert len(found) == 1, found
    return found[0]


@pytest.mark.parametrize("n", [1, 255, 257, 1500])
def test_wrapper_padding_and_block_choice(n):
    """Any ray count: the wrapper pads to whole blocks with pre-terminated
    rays, launches ceil(n / block) programs, and hands back exactly n rays
    that match the XLA path; a (2, n) batch round-trips its shape."""
    env = make_env(jnp.asarray(0.5))
    x0, d0 = rays(n, seed=n)
    s0 = initial(env, x0, d0)
    for block in (32, 128):
        grid = _grid(lambda s: integrate_pallas(env, s, CFG, block=block,
                                                interpret=True), s0)
        assert grid == (-(-n // block),)
    out = integrate_pallas(env, s0, CFG, block=32, interpret=True)
    assert out.x.shape == (n, 3) and out.status.shape == (n,)
    assert_same_state(integrate_fixed(env, s0, CFG), out)
    s2 = jax.tree.map(lambda a: jnp.stack([a, a]), s0)
    out2 = integrate_pallas(env, s2, CFG, block=32, interpret=True)
    assert out2.x.shape == (2, n, 3) and out2.lam.shape == (2, n)
    np.testing.assert_array_equal(np.asarray(out2.status[1]),
                                  np.asarray(out.status))


def test_block_must_be_a_power_of_two():
    env = make_env(jnp.asarray(0.5))
    s0 = initial(env, *rays(8))
    for bad in (16, 96, 100):
        with pytest.raises(ValueError, match="power of two"):
            integrate_pallas(env, s0, CFG, block=bad, interpret=True)


def test_kernel_under_vmap_and_jit():
    """The kernel composes with jit and vmap (a batch of black-hole masses
    becomes an extra grid axis) and matches the XLA path per mass."""
    x0, d0 = rays(200, seed=9)
    masses = jnp.asarray([0.4, 0.5])

    def run(m, kern):
        env = make_env(m)
        s0 = initial(env, x0, d0)
        return (integrate_pallas(env, s0, CFG, interpret=True) if kern
                else integrate_fixed(env, s0, CFG))

    a = jax.jit(jax.vmap(lambda m: run(m, True)))(masses)
    b = jax.vmap(lambda m: run(m, False))(masses)
    np.testing.assert_array_equal(np.asarray(a.status), np.asarray(b.status))
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x), atol=2e-5)


def test_checkpoints_are_the_scan_segment_states():
    """The gradient forward writes the state before every remat segment of
    integrate_fixed: checkpoint k equals the XLA scan after k * seg steps
    (the backward recomputes each segment from there)."""
    env = make_env(jnp.asarray(0.5))
    x0, d0 = rays(300, seed=11)
    s0 = initial(env, x0, d0)
    cfg = dataclasses.replace(CFG, n_steps=50)      # seg 7, tail of 1
    seg, n_full, rem = _segments(cfg)
    final, ck = pk._forward(env, s0, cfg, 64, True, True)
    assert ck.x.shape == (n_full + (rem > 0), 300, 3)
    for k in (0, 3, n_full):
        ref = (integrate_fixed(env, s0, dataclasses.replace(
            cfg, n_steps=k * seg)) if k else s0)
        np.testing.assert_array_equal(np.asarray(ck.status[k]),
                                      np.asarray(ref.status))
        np.testing.assert_allclose(np.asarray(ck.x[k]), np.asarray(ref.x),
                                   atol=2e-5)
    assert_same_state(integrate_fixed(env, s0, cfg), final)


@pytest.mark.parametrize("spin,events", [(None, False), (None, True),
                                         (0.45, False), (0.45, True)])
def test_kernel_lowers_to_triton(spin, events):
    """Forward and gradient programs lower for CUDA through Pallas' Triton
    route on this CPU host (every primitive of the step has a Triton
    lowering rule); the GPU compiler itself runs only on the card."""
    n = 1000
    x0, d0 = rays(n)
    cfg = IntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                           dt_boost_r_ref=1.7, dt_power=1.5)

    def f(m):
        env = GeodesicEnv(
            mass=m, r_capture=jnp.float32(1.0), r_escape=jnp.float32(70.0),
            lam_max=jnp.float32(100.0),
            spin=None if spin is None else jnp.float32(spin),
            disk=DiskGeom(r_in=jnp.float32(2.0), r_out=jnp.float32(6.0))
            if events else None,
            spheres=SphereGeom(center=jnp.ones((4, 3)), radius=jnp.ones(4))
            if events else None)
        s = integrate_pallas(env, initial(env, x0, d0), cfg)
        return jnp.sum(s.x ** 2)

    for fn in (f, jax.grad(f)):
        text = jax.jit(fn).trace(jnp.float32(0.5)).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_kernel_matches_scan_on_gpu(gpu):
    """On the card: chip_smoke.py's kernel gate (four variants, camera fan
    outside the critical band, one-step tie rule, mass gradient) on 2^17
    rays of the compiled kernel against the XLA scan."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_kernel(n=1 << 17)
