"""curvedpy-compatible API surface.

The reference render engines drive an external numerical backend,
``curvedpy`` (reference README.md:23-24,174-211); its API was reconstructed
from every call site (SURVEY.md §2.3).  This module provides drop-in
batched JAX equivalents so code written against the reference's backend runs
unchanged on this framework -- each class documents the reference call site
it serves.  Inputs/outputs are numpy-friendly (lists and ndarrays), matching
how the Blender engines call curvedpy; internally everything is one jitted
batched program.

Geometrized units throughout: G = c = 1, horizon r_s = 2M (reference
comment RelativisticRenderEngine.py:95; default mass 0.5 => r_s = 1,
RelativisticRenderEngine.py:506).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops import states
from .ops.geodesic import null_init, xdot
from .ops.integrate import GeodesicEnv, IntegratorConfig, integrate, trajectory
from .camera.pinhole import Camera, generate_rays, pixel_grid

Array = jax.Array


def _np(v):
    return np.asarray(v)


class Conversions:
    """Cartesian <-> spherical coordinate/velocity conversion.

    Reference call site: ``Conversions().convert_xyz_to_sph(x0_xyz, k0_xyz)``
    used diagnostically before every geodesic cast
    (RelativisticRenderEngine.py:289-291).
    """

    def convert_xyz_to_sph(self, x_xyz, k_xyz):
        """(x, k) Cartesian -> ((r, th, ph), (kr, kth, kph)).

        Velocity components are the chain-rule pushforwards
        kr = dr/dt, kth = dth/dt, kph = dph/dt.
        """
        x, y, z = [np.asarray(v, np.float64) for v in np.moveaxis(
            np.asarray(x_xyz, np.float64), -1, 0)]
        kx, ky, kz = [np.asarray(v, np.float64) for v in np.moveaxis(
            np.asarray(k_xyz, np.float64), -1, 0)]
        rho = np.sqrt(x * x + y * y)
        r = np.sqrt(rho * rho + z * z)
        th = np.arccos(np.clip(z / np.maximum(r, 1e-300), -1.0, 1.0))
        ph = np.arctan2(y, x)
        kr = (x * kx + y * ky + z * kz) / np.maximum(r, 1e-300)
        # cos th = z/r  =>  th' = (z kr - kz r) / (r^2 sin th)
        kth = (z * kr - kz * r) / np.maximum(r * r * (rho / r), 1e-300)
        kph = (x * ky - y * kx) / np.maximum(rho * rho, 1e-300)
        sph = np.stack([r, th, ph], axis=-1)
        ksph = np.stack([kr, kth, kph], axis=-1)
        return sph, ksph

    def convert_sph_to_xyz(self, sph, ksph):
        r, th, ph = np.moveaxis(np.asarray(sph, np.float64), -1, 0)
        kr, kth, kph = np.moveaxis(np.asarray(ksph, np.float64), -1, 0)
        st, ct = np.sin(th), np.cos(th)
        sp, cp = np.sin(ph), np.cos(ph)
        x = r * st * cp
        y = r * st * sp
        z = r * ct
        kx = kr * st * cp + r * ct * cp * kth - r * st * sp * kph
        ky = kr * st * sp + r * ct * sp * kth + r * st * cp * kph
        kz = kr * ct - r * st * kth
        return np.stack([x, y, z], -1), np.stack([kx, ky, kz], -1)


class GeodesicIntegratorSchwarzschild:
    """Whole-scene null-geodesic integrator.

    Reference: instantiated once per render with
    ``curvedpy.GeodesicIntegratorSchwarzschild(mass, time_like=False)``
    (RelativisticRenderEngine.py:134) and called per ray as
    ``calc_trajectory(k0_xyz, x0_xyz, max_step, curve_end, nr_points_curve)``
    (RelativisticRenderEngine.py:293-308).  Here ``calc_trajectory`` accepts
    a single ray OR a batch (leading dims broadcast) and runs one jitted
    program -- the per-pixel scipy solve becomes one batched device solve.
    """

    def __init__(self, mass=0.5, time_like=False, verbose=False, spin=None,
                 backend="jax"):
        if backend not in ("jax", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if time_like and backend == "native":
            raise ValueError(
                "the native f64 oracle integrates null geodesics only; "
                "use backend='jax' for time_like=True")
        # time_like=True integrates MASSIVE test particles (the reference
        # flag at RelativisticRenderEngine.py:134): k0 is then dx/dtau of
        # any magnitude and the 4-velocity is normalized to
        # g_{mu nu} u^mu u^nu = -1 (ops/geodesic.timelike_init); the
        # Hamiltonian integrator is otherwise identical.
        self.time_like = bool(time_like)
        self.mass = float(mass)
        self.spin = None if spin in (None, 0, 0.0) else float(spin)
        self.verbose = verbose
        # 'native': the C++ f64 adaptive Dormand-Prince oracle (native/) --
        # the closest twin of the reference's scipy solve_ivp RK45 path
        # (adaptive steps, max_step honored as a hard cap).
        self.backend = backend
        # curvedpy exposes sympy metric objects (SW.g, SW.gam_y -- reference
        # README.md:174-186); here the same names are batched numeric
        # closures over the Metric family: g(x4) -> (..., 4, 4) and
        # gam_y(x4) -> (..., 4, 4, 4) Christoffels via forward-mode AD.
        from .models import kerr_ks_metric, schwarzschild_ks_metric

        self.metric_obj = (
            schwarzschild_ks_metric(self.mass) if self.spin is None
            else kerr_ks_metric(self.mass, self.spin))
        self.g = self.metric_obj.g
        self.gam_y = self.metric_obj.christoffel

    def _env(self, r_escape, curve_end):
        return GeodesicEnv(
            mass=jnp.asarray(self.mass, jnp.float32),
            spin=None if self.spin is None else jnp.asarray(
                self.spin, jnp.float32),
            r_capture=jnp.asarray(2.0 * self.mass, jnp.float32),
            r_escape=jnp.asarray(r_escape, jnp.float32),
            lam_max=jnp.asarray(curve_end, jnp.float32),
        )

    def calc_trajectory(self, k0_xyz, x0_xyz, max_step=0.1, curve_end=50.0,
                        nr_points_curve=10000, verbose=False,
                        r_escape=None):
        """Returns (k_xyz, x_xyz, result) with trajectories shaped
        (..., 3, T) and result dict of per-ray flags, exactly the contract
        consumed at RelativisticRenderEngine.py:293-313:
        ``result['start_inside_hole']``, ``result['hit_blackhole']``,
        optional ``result['error']``; plus ``end_loc``/``end_dir``.
        """
        x0 = jnp.asarray(x0_xyz, jnp.float32)
        d0 = jnp.asarray(k0_xyz, jnp.float32)
        single = x0.ndim == 1
        if single:
            x0, d0 = x0[None], d0[None]
        if not self.time_like:   # massive particles keep |dx/dtau|
            d0 = d0 / jnp.linalg.norm(d0, axis=-1, keepdims=True)

        r0 = float(jnp.max(jnp.linalg.norm(x0, axis=-1)))
        resc = r_escape if r_escape is not None else max(
            2.0 * r0, 20.0 * 2.0 * self.mass + r0)
        if self.backend == "native":
            return self._calc_trajectory_native(
                x0, d0, max_step, curve_end, nr_points_curve, resc, single)
        n_steps = max(1, int(np.ceil(curve_end / max_step)))
        n_store = min(n_steps, nr_points_curve)
        cfg = IntegratorConfig(n_steps=n_steps, dt=float(max_step),
                               dt_boost=1.0, backend="scan")
        env = self._env(resc, curve_end)

        xs, ps, s = trajectory(env, x0, d0, cfg,
                               time_like=self.time_like)
        # velocities along the path (coordinate velocity = unit ray speed)
        vs = xdot(xs, ps, s.E[None], env.mass, env.spin)
        if n_store < xs.shape[0]:
            idx = jnp.linspace(0, xs.shape[0] - 1, n_store).astype(jnp.int32)
            xs, vs = xs[idx], vs[idx]

        # (T, N, 3) -> (N, 3, T) to match curvedpy's (3, T) per ray
        x_out = _np(jnp.moveaxis(xs, 0, -1))
        k_out = _np(jnp.moveaxis(vs, 0, -1))

        status = _np(s.status)
        inside0 = _np(jnp.linalg.norm(x0, axis=-1)) <= 2.0 * self.mass
        result = {
            "start_inside_hole": inside0,
            "hit_blackhole": (status == states.CAPTURED)
            | (status == states.INSIDE_HORIZON) | inside0,
            "end_loc": _np(s.x),
            "end_dir": _np(xdot(s.x, s.p, s.E, env.mass, env.spin)
                           / jnp.maximum(jnp.linalg.norm(
                               xdot(s.x, s.p, s.E, env.mass, env.spin),
                               axis=-1, keepdims=True), 1e-20)),
            "lam": _np(s.lam),
            "status": status,
        }
        if (status == states.ERROR).any():
            result["error"] = np.where(status == states.ERROR,
                                       "Outside", "")
        if single:
            x_out, k_out = x_out[0], k_out[0]
            result = {k: (v[0] if isinstance(v, np.ndarray) else v)
                      for k, v in result.items()}
        return k_out, x_out, result

    def _calc_trajectory_native(self, x0, d0, max_step, curve_end,
                                nr_points_curve, r_escape, single):
        """f64 adaptive path via the C++ oracle (native/src/geodesic.cpp):
        per-ray dense trajectories like the reference's scipy solve_ivp
        (RelativisticRenderEngine.py:293-294), but multithreaded and in
        Kerr-Schild Hamiltonian form."""
        from . import native

        x0 = np.asarray(x0, np.float64)
        d0 = np.asarray(d0, np.float64)
        n = x0.shape[0]
        r_cap = 2.0 * self.mass if self.spin is None else (
            self.mass + np.sqrt(max(self.mass ** 2 - self.spin ** 2, 0.0)))
        # One ctypes crossing for the WHOLE batch, rays solved in parallel
        # C++ threads (native.trajectory_batch) -- a per-ray Python loop
        # here would serialize a camera-scale batch into N ODE solves plus
        # N FFI crossings (the round-4 review's 1M-iteration trap).
        out = native.trajectory_batch(
            x0, d0, mass=self.mass, spin=self.spin, r_capture=r_cap,
            r_escape=r_escape, lam_max=curve_end, max_step=max_step,
            max_points=int(nr_points_curve))
        np_pts = out["n_points"]
        xs = [out["traj_x"][i, :np_pts[i]] for i in range(n)]
        ks = [out["traj_v"][i, :np_pts[i]] for i in range(n)]
        lams = out["lam"]
        status = out["status"]
        # The oracle tests "start inside" with the Kerr-Schild radius
        # (geodesic.cpp integrate_one), which is SMALLER than the Euclidean
        # norm for spin != 0 -- trust its INSIDE_HORIZON status rather than
        # recomputing with the wrong radius, and include it in hit_blackhole
        # to match the JAX path above.
        inside0 = status == states.INSIDE_HORIZON
        end_loc = np.stack([t[-1] for t in xs])
        end_dir = np.stack([k[-1] for k in ks])
        end_dir = end_dir / np.maximum(
            np.linalg.norm(end_dir, axis=-1, keepdims=True), 1e-300)
        result = {
            "start_inside_hole": inside0,
            "hit_blackhole": (status == states.CAPTURED) | inside0,
            "end_loc": end_loc,
            "end_dir": end_dir,
            "lam": np.asarray(lams),
            "status": status,
        }
        if (status == states.ERROR).any():
            result["error"] = np.where(status == states.ERROR, "Outside", "")
        # (N, 3, T) ragged -> per-ray arrays; batch callers get lists
        x_out = [t.T for t in xs]
        k_out = [k.T for k in ks]
        if single:
            x_out, k_out = x_out[0], k_out[0]
            result = {k: (v[0] if isinstance(v, np.ndarray) else v)
                      for k, v in result.items()}
        return k_out, x_out, result


class SchwarzschildGeodesic:
    """Sphere-of-influence solver (the Gen-1 engine's backend).

    Reference: ``curvedpy.SchwarzschildGeodesic(metric)`` re-instantiated
    every row as a leak workaround (LimitedRelativisticRenderEngine.py:90,
    203-204 -- no leak here, instantiation is free) and called as
    ``SW.ray_trace(direction, loc_hit, exit_tolerance,
    ratio_obj_to_blackhole, curve_end, max_step)``
    (LimitedRelativisticRenderEngine.py:273-278).

    Unit convention: the BH sphere object of the Blender scene maps to a
    sphere of radius ``ratio_obj_to_blackhole`` in Schwarzschild units
    (r_s = 1, M = 0.5); ``loc_hit`` is the entry point on that sphere in
    BH-local coordinates.
    """

    def __init__(self, metric="schwarzschild", mass=0.5):
        if metric not in ("schwarzschild", "flat"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.mass = float(mass) if metric == "schwarzschild" else 0.0
        # numeric twins of curvedpy's sympy SW.g / SW.gam_y (README.md:174-186)
        from .models import flat_metric, schwarzschild_ks_metric

        self.metric_obj = (flat_metric() if metric == "flat"
                           else schwarzschild_ks_metric(self.mass))
        self.g = self.metric_obj.g
        self.gam_y = self.metric_obj.christoffel

    def approximateCurveEnd(self, ratio):
        """Affine-length budget heuristic; the reference's commented formula
        ``50 + 2*50*(ratio/20 - 1)`` (LimitedRelativisticRenderEngine.py:279),
        floored at the sphere-crossing length."""
        return max(50.0 + 100.0 * (ratio / 20.0 - 1.0), 3.0 * ratio)

    def ray_trace(self, direction, loc_hit, exit_tolerance=0.1,
                  ratio_obj_to_blackhole=20.0, curve_end=None, max_step=0.1):
        """Trace from the sphere entry point until the ray exits the sphere
        of influence (or is captured).  Returns
        ``(x, y, z, end_loc, end_dir, mes)`` with per-step trajectory
        coordinates -- the tuple unpacked at
        LimitedRelativisticRenderEngine.py:273-276.  Batched inputs allowed.
        """
        if curve_end is None:
            curve_end = self.approximateCurveEnd(ratio_obj_to_blackhole)
        x0 = jnp.asarray(loc_hit, jnp.float32)
        d0 = jnp.asarray(direction, jnp.float32)
        single = x0.ndim == 1
        if single:
            x0, d0 = x0[None], d0[None]
        d0 = d0 / jnp.linalg.norm(d0, axis=-1, keepdims=True)
        # nudge inside so the exit test doesn't fire at the entry point
        x0 = x0 * (1.0 - 1e-4)

        n_steps = max(1, int(np.ceil(curve_end / max_step)))
        cfg = IntegratorConfig(n_steps=n_steps, dt=float(max_step),
                               dt_boost=1.0, backend="scan")
        env = GeodesicEnv(
            mass=jnp.asarray(self.mass, jnp.float32),
            r_capture=jnp.asarray(2.0 * self.mass, jnp.float32),
            r_escape=jnp.asarray(
                ratio_obj_to_blackhole * (1.0 + exit_tolerance), jnp.float32),
            lam_max=jnp.asarray(curve_end, jnp.float32),
        )
        xs, ps, s = trajectory(env, x0, d0, cfg)

        v = xdot(s.x, s.p, s.E, env.mass, None)
        end_dir = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
        status = _np(s.status)
        mes = {
            "hit_blackhole": status == states.CAPTURED,
            "start_inside_hole": status == states.INSIDE_HORIZON,
            "exited": status == states.ESCAPED,
            "status": status,
        }
        if (status == states.BUDGET).any():
            # ray never left the sphere within budget: the reference's
            # rogue-'Outside' taxonomy (rendered red,
            # LimitedRelativisticRenderEngine.py:311-314)
            mes["error"] = np.where(status == states.BUDGET, "Outside", "")
        xyz = _np(jnp.moveaxis(xs, 0, -1))  # (N, 3, T)
        x_, y_, z_ = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        end_loc = _np(s.x)
        end_dir = _np(end_dir)
        if single:
            x_, y_, z_ = x_[0], y_[0], z_[0]
            end_loc, end_dir = end_loc[0], end_dir[0]
            mes = {k: (v[0] if isinstance(v, np.ndarray) else v)
                   for k, v in mes.items()}
        return x_, y_, z_, end_loc, end_dir, mes


class ApproxSchwarzschildGeodesic:
    """Fast surrogate for the sphere-of-influence trace (the reference's
    ``approx`` mode, LimitedRelativisticRenderEngine.py:39-40,100-101,269).

    The reference planned "a Tensorflow model or interpolation"
    (README.md:237).  Here the surrogate is EXACT up to interpolation error
    by spherical symmetry: for a photon entering the sphere of influence,
    the exit state depends only on the impact parameter b, so a 1D table of
    the scattering map b -> (deflection angle, exit offset) built once with
    the real integrator replaces every subsequent ODE solve with two table
    lookups and a rotation.  Captured rays are b < b_table cutoff.
    """

    def __init__(self, ratio_obj_to_blackhole=20.0, exit_tolerance=0.1,
                 mass=0.5, n_table=512):
        self.ratio = float(ratio_obj_to_blackhole)
        self.exit_tolerance = float(exit_tolerance)
        self.mass = float(mass)
        self.n_table = int(n_table)
        self._build()

    def _build(self):
        R = self.ratio
        bs = np.linspace(0.0, R * 0.999, self.n_table).astype(np.float32)
        # Canonical geometry: enter at x = (-sqrt(R^2-b^2), b, 0) moving +x.
        x0 = np.stack([-np.sqrt(np.maximum(R * R - bs * bs, 0.0)), bs,
                       np.zeros_like(bs)], -1)
        d0 = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32),
                     (self.n_table, 1))
        sw = SchwarzschildGeodesic(mass=self.mass)
        curve_end = sw.approximateCurveEnd(R)
        _, _, _, end_loc, end_dir, mes = sw.ray_trace(
            d0, x0, self.exit_tolerance, R, curve_end, max_step=0.05)
        self._b = bs
        self._captured = np.asarray(mes["hit_blackhole"])
        self._end_loc = np.asarray(end_loc, np.float32)
        self._end_dir = np.asarray(end_dir, np.float32)

    def generatedRayTracer(self, loc, direction):
        """(entry loc, dir) -> (end_loc, end_dir, mes) via the table.

        Reference call: ``aSW.generatedRayTracer(loc_hit, direction)``
        (LimitedRelativisticRenderEngine.py:269).
        """
        loc = np.asarray(loc, np.float32)
        d = np.asarray(direction, np.float32)
        single = loc.ndim == 1
        if single:
            loc, d = loc[None], d[None]
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)

        # Decompose into the canonical scattering frame: b = |loc x d|.
        bvec = loc - np.sum(loc * d, -1, keepdims=True) * d
        b = np.linalg.norm(bvec, axis=-1)
        # Frame: e1 = d, e2 = unit(bvec) (or any perp for b=0), e3 = e1 x e2
        e1 = d
        safe = b > 1e-6
        e2 = np.where(safe[..., None],
                      bvec / np.maximum(b[..., None], 1e-20),
                      _any_perp(d))
        e3 = np.cross(e1, e2)

        idx = np.clip(np.searchsorted(self._b, b), 1, self.n_table - 1)
        t = (b - self._b[idx - 1]) / np.maximum(
            self._b[idx] - self._b[idx - 1], 1e-20)
        t = np.clip(t, 0.0, 1.0)[..., None]

        def lerp(tab):
            return tab[idx - 1] * (1 - t) + tab[idx] * t

        el, ed = lerp(self._end_loc), lerp(self._end_dir)
        cap = (self._captured[idx - 1] | self._captured[idx])
        # canonical frame has entry at (-sqrt(R^2-b^2), b, 0), dir +x:
        # map (cx, cy, cz) -> cx*e1 + cy*e2 + cz*e3
        def to_world(c):
            return (c[..., 0:1] * e1 + c[..., 1:2] * e2 + c[..., 2:3] * e3)

        end_loc = to_world(el)
        end_dir = to_world(ed)
        end_dir = end_dir / np.maximum(
            np.linalg.norm(end_dir, axis=-1, keepdims=True), 1e-20)
        mes = {"hit_blackhole": cap, "start_inside_hole": np.zeros_like(cap)}
        if single:
            end_loc, end_dir = end_loc[0], end_dir[0]
            mes = {k: v[0] for k, v in mes.items()}
        return end_loc, end_dir, mes


def _any_perp(d):
    """A unit vector perpendicular to each row of d."""
    ref = np.where(np.abs(d[..., 0:1]) < 0.9,
                   np.asarray([1.0, 0.0, 0.0], np.float32),
                   np.asarray([0.0, 1.0, 0.0], np.float32))
    p = np.cross(d, ref)
    return p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-20)


class ApproxKerrGeodesic:
    """Learned surrogate for the sphere-of-influence trace around a
    SPINNING hole — the reference's planned "Tensorflow model"
    (README.md:237), which a table cannot provide for Kerr (spin breaks the
    spherical symmetry that makes ``ApproxSchwarzschildGeodesic`` exact).

    Same ``generatedRayTracer`` protocol as the Schwarzschild surrogate
    (reference call site LimitedRelativisticRenderEngine.py:269).  The MLP
    is trained on construction against the live integrator
    (models/surrogate.py) unless ``load_path`` restores a saved one; pass
    ``save_path`` to persist (the reference's reload-on-parameter-change
    semantics, LimitedRelativisticRenderEngine.py:96-101, with npz instead
    of a pickled sklearn/keras object).
    """

    def __init__(self, ratio_obj_to_blackhole=20.0, exit_tolerance=0.1,
                 mass=0.5, a=0.45, train_steps=4000, batch=4096,
                 seed=0, load_path=None, save_path=None, width=256, depth=5):
        from .models import surrogate as _sur

        self.ratio = float(ratio_obj_to_blackhole)
        self.exit_tolerance = float(exit_tolerance)
        self.mass = float(mass)
        self.a = float(a)
        self.cfg = _sur.SurrogateConfig(
            width=width, depth=depth, r_influence=self.ratio,
            exit_tolerance=self.exit_tolerance)
        if load_path is not None:
            self.model = _sur.load_surrogate(load_path)
            self.history = None
            # A surrogate is only valid for the physics it was trained on
            # (the npz stores them for exactly this check -- the reference
            # RELOADS the surrogate when these parameters change,
            # LimitedRelativisticRenderEngine.py:96-101); a silent mismatch
            # between the instance attributes and the loaded weights would
            # trace wrong physics.  Same check as io_.config.build_limited.
            m = self.model
            mismatches = [
                (name, got, want)
                for name, got, want in (
                    ("mass", float(m.mass), self.mass),
                    ("a", float(m.spin), self.a),
                    ("ratio_obj_to_blackhole", float(m.r_influence),
                     self.ratio),
                    ("exit_tolerance",
                     float(m.r_exit) / float(m.r_influence) - 1.0
                     if m.r_exit is not None else self.exit_tolerance,
                     self.exit_tolerance),
                )
                if abs(got - want) > 1e-4 * max(abs(want), 1.0)
            ]
            if mismatches:
                detail = ", ".join(f"{n}: loaded={g:g} vs requested={w:g}"
                                   for n, g, w in mismatches)
                raise ValueError(
                    f"surrogate {load_path!r} was trained for a different "
                    f"setup ({detail}); retrain (omit load_path) or "
                    f"construct with the matching parameters")
        else:
            self.model, self.history = _sur.train_surrogate(
                jax.random.PRNGKey(seed), mass=self.mass,
                spin=(self.a if self.a != 0.0 else None), cfg=self.cfg,
                steps=train_steps, batch=batch)
            if save_path is not None:
                _sur.save_surrogate(save_path, self.model)
        self._trace = jax.jit(self.model.trace)

    def generatedRayTracer(self, loc, direction):
        """(entry loc, dir) -> (end_loc, end_dir, mes) via the MLP."""
        loc = np.asarray(loc, np.float32)
        d = np.asarray(direction, np.float32)
        single = loc.ndim == 1
        if single:
            loc, d = loc[None], d[None]
        end_loc, end_dir, cap = self._trace(jnp.asarray(loc), jnp.asarray(d))
        end_loc, end_dir, cap = _np(end_loc), _np(end_dir), _np(cap)
        mes = {"hit_blackhole": cap, "start_inside_hole": np.zeros_like(cap)}
        if single:
            end_loc, end_dir = end_loc[0], end_dir[0]
            mes = {k: v[0] for k, v in mes.items()}
        return end_loc, end_dir, mes


class RelativisticCamera:
    """Batched whole-camera geodesic precompute (the Gen-3 backend).

    Reference: ``RelativisticCamera(resolution, field_of_view, a,
    camera_location, camera_rotation_euler)`` + ``.run()`` + pickle
    ``.load(pkl)`` exposing ``ray_blackhole_hit[H, W]`` and
    ``ray_end[H, W, 6]`` (RelativisticRenderEngineCamEdition.py:206-229).
    Kerr spin ``a`` is first-class (a=0.9 pkls, :216-221).  Persistence is
    ``.npz`` (safetensors-style arrays, no arbitrary code execution), with
    the same parameter-encoding behavior as the reference's pkl names.
    """

    def __init__(self, resolution=(124, 124), field_of_view=(0.3, 0.3),
                 a=0.0, mass=0.5, camera_location=(0.0, 0.0, 25.0),
                 camera_rotation_euler=(0.0, 0.0, 0.0),
                 max_step=0.1, curve_end=100.0, n_steps=None):
        self.resolution = tuple(resolution)
        self.field_of_view = tuple(np.atleast_1d(field_of_view).tolist()
                                   if np.ndim(field_of_view) else
                                   (field_of_view, field_of_view))
        if len(self.field_of_view) == 1:
            self.field_of_view = self.field_of_view * 2
        self.a = float(a)
        self.mass = float(mass)
        self.camera_location = tuple(camera_location)
        self.camera_rotation_euler = tuple(camera_rotation_euler)
        self.max_step = float(max_step)
        self.curve_end = float(curve_end)
        self.n_steps = n_steps
        self.ray_blackhole_hit = None
        self.ray_end = None

    def run(self, verbose=False, verbose_lvl=0):
        h, w = self.resolution
        cam = Camera.make(position=self.camera_location,
                          euler=self.camera_rotation_euler,
                          fov=self.field_of_view)
        ys, xs = pixel_grid(w, h)
        o, d = generate_rays(cam, w, h, ys, xs, None)

        spin = None if self.a == 0.0 else jnp.asarray(self.a, jnp.float32)
        cam_r = float(np.linalg.norm(self.camera_location))
        n_steps = self.n_steps or max(
            64, int(np.ceil(self.curve_end / self.max_step)))
        env = GeodesicEnv(
            mass=jnp.asarray(self.mass, jnp.float32), spin=spin,
            r_capture=jnp.asarray(
                2.0 * self.mass if spin is None else
                self.mass + np.sqrt(max(self.mass**2 - self.a**2, 0.0)),
                jnp.float32),
            r_escape=jnp.asarray(2.0 * cam_r + 40.0 * self.mass, jnp.float32),
            lam_max=jnp.asarray(self.curve_end, jnp.float32),
        )
        cfg = IntegratorConfig(n_steps=n_steps, dt=self.max_step)
        from .ops.integrate import launch, final_direction

        s = launch(env, o, d, cfg)
        end_dir = final_direction(env, s)
        hit = ((s.status == states.CAPTURED)
               | (s.status == states.INSIDE_HORIZON))
        self.ray_blackhole_hit = np.asarray(hit).astype(np.int8)
        self.ray_end = np.concatenate(
            [np.asarray(s.x), np.asarray(end_dir)], axis=-1)
        if verbose:
            print(f"RelativisticCamera.run: {h}x{w}, a={self.a}, "
                  f"captured {int(hit.sum())}/{h * w}")
        return self

    def render(self, background=None, test_output=False):
        """Shade the precomputed ray field -> (H, W, 4) RGBA.

        Exactly the Gen-3 engine's shading pass
        (RelativisticRenderEngineCamEdition.py:224-229,424-443): black where
        ``ray_blackhole_hit``, else equirect lookup of the stored exit
        direction (renormalized, :433-437); a missing background renders
        red (:441-443); ``test_output`` uses the direction-gradient debug
        background instead.
        """
        if self.ray_end is None:
            raise RuntimeError("run() or load() the camera first")
        import jax.numpy as jnp_

        from .scene.texture import sample_equirect

        h, w = self.resolution
        d = np.asarray(self.ray_end[..., 3:6], np.float32)
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
        if test_output:
            rgb = 0.5 * (d + 1.0)
        elif background is None:
            rgb = np.broadcast_to(
                np.asarray([1.0, 0.0, 0.0], np.float32), (h, w, 3)).copy()
        else:
            rgb = np.asarray(sample_equirect(
                jnp_.asarray(background, jnp_.float32), jnp_.asarray(d)))
        hit = np.asarray(self.ray_blackhole_hit, bool)
        rgb = np.where(hit[..., None], 0.0, rgb)
        return np.concatenate(
            [rgb, np.ones((h, w, 1), np.float32)], axis=-1)

    def save(self, path):
        np.savez_compressed(
            path,
            ray_blackhole_hit=self.ray_blackhole_hit,
            ray_end=self.ray_end,
            meta=np.asarray([*self.resolution, *self.field_of_view,
                             self.a, self.mass, *self.camera_location,
                             *self.camera_rotation_euler, self.max_step,
                             self.curve_end], np.float64),
        )
        return path

    def load(self, path):
        with np.load(path) as z:
            self.ray_blackhole_hit = z["ray_blackhole_hit"]
            self.ray_end = z["ray_end"]
            m = z["meta"]
        self.resolution = (int(m[0]), int(m[1]))
        self.field_of_view = (float(m[2]), float(m[3]))
        self.a, self.mass = float(m[4]), float(m[5])
        self.camera_location = tuple(m[6:9])
        self.camera_rotation_euler = tuple(m[9:12])
        self.max_step, self.curve_end = float(m[12]), float(m[13])
        return self
