"""Learned geodesic surrogate: the reference's planned "Tensorflow model or
interpolation" fast path (/root/reference/README.md:237) carried past the
reference.

For Schwarzschild, spherical symmetry makes a 1D scattering table exact up
to interpolation (``render/limited.py:SurrogateTable`` — the shipped approx
mode).  **Kerr breaks that symmetry**: the sphere-of-influence scattering
map ``(entry loc, dir) -> (exit loc, dir, captured)`` genuinely depends on
four irreducible degrees of freedom, so no low-dimensional table exists.
Here that map is LEARNED: a small MLP trained on the device against the
integrator itself — every optimizer step draws a fresh random ray batch and
labels it with the real integrator in the same jitted program (no stored
dataset, no possibility of overfitting), exactly the "collisions with the
truth model in the loop" setup the reference could not attempt with one
scipy solve per ray.

The two EXACT symmetries of Kerr in Kerr-Schild Cartesian form are
canonicalized out in closed form, so the network only learns the quotient:

* **axisymmetry** — rotations about the spin (+z) axis: ``l_x + i l_y =
  (r - i a)(x + i y)/(r^2 + a^2)`` transforms as a vector, H is invariant
  (models/kerr.py), hence the scattering map is exactly Rz-equivariant;
* **equatorial reflection** — ``z -> -z`` leaves H and (l_x, l_y)
  unchanged and flips ``l_z = z/r``, so the map is exactly
  flip-equivariant.

Canonical frame: entry azimuth rotated to phi = 0, entry z reflected to
z >= 0.  Equivariance of the full ``trace`` is then an architectural
guarantee (tested in tests/test_surrogate.py), not a learned property.

Inference is a handful of dense matmuls (float32, or ``bfloat16`` with f32
accumulation) -- the one workload in this framework that can use the
matrix units rather than plain elementwise arithmetic.  The surrogate
exposes the same ``.trace(entry, d)`` protocol as ``SurrogateTable``, so it drops straight into the Gen-1 hybrid
renderer (``render_limited_rays(..., table=...)``) and into the compat
layer (``compat.ApproxKerrGeodesic.generatedRayTracer``, mirroring the
reference surrogate call at
/root/reference/raytracer/LimitedRelativisticRenderEngine.py:269).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops import states
from ..ops.integrate import GeodesicEnv, IntegratorConfig, launch, final_direction

Array = jax.Array


# =============================================================================
# Configuration.
# =============================================================================
@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """Architecture + labeling-integrator budget for one surrogate."""

    width: int = 256
    depth: int = 5              # number of hidden layers
    r_influence: float = 20.0   # sphere-of-influence radius (scene units of M)
    exit_tolerance: float = 0.1  # exit shell thickness (ref :273-278)
    # Matmul precision: 'f32' (accurate default -- bf16's ~4e-3 relative
    # rounding on the residual head is itself a multi-pixel error floor at
    # flagship resolution) or 'bf16' (the fastest path, preview-grade).
    precision: str = "f32"
    # Integrator budget used to label training batches (and to evaluate):
    n_steps: int = 512
    dt: float = 0.05
    lam_max: float = 200.0
    dt_boost: float = 4.0
    backend: str = "auto"       # RK4 kernel on a GPU, XLA scan elsewhere

    @property
    def n_features(self) -> int:
        return 11

    @property
    def n_outputs(self) -> int:
        return 7  # exit dir (3) + exit loc / R (3) + capture logit (1)


# =============================================================================
# Exact symmetry canonicalization.
# =============================================================================
def _rz(phi):
    """Batched active rotation matrix about +z by ``phi``: (..., 3, 3)."""
    c, s = jnp.cos(phi), jnp.sin(phi)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


def _rotate(rot, v):
    """Per-ray 3x3 rotation, in full f32 (not TF32 on a GPU)."""
    return jnp.einsum("...ij,...j->...i", rot, v,
                      precision=jax.lax.Precision.HIGHEST)


def canonicalize(entry, d):
    """Map (entry, d) into the symmetry-canonical frame.

    Returns ``(entry_c, d_c, phi, flip)`` with entry_c azimuth 0 and
    entry_c_z >= 0; ``decanonicalize`` inverts the transform on outputs.
    """
    phi = jnp.arctan2(entry[..., 1], entry[..., 0])
    rot = _rz(-phi)
    entry_c = _rotate(rot, entry)
    d_c = _rotate(rot, d)
    flip = entry_c[..., 2] < 0.0
    sgn = jnp.where(flip, -1.0, 1.0)
    entry_c = entry_c.at[..., 2].multiply(sgn)
    d_c = d_c.at[..., 2].multiply(sgn)
    return entry_c, d_c, phi, flip


def decanonicalize(v, phi, flip):
    """Undo ``canonicalize`` on a canonical-frame vector field ``v``."""
    sgn = jnp.where(flip, -1.0, 1.0)
    v = v.at[..., 2].multiply(sgn)
    return _rotate(_rz(phi), v)


def _features(entry_c, d_c, R):
    """Canonical-frame input features (..., 11).

    Raw geometry plus the angular-momentum-like invariants the scattering
    physics is organized around (b-vector ~ entry x d).  The LOG of the
    impact parameter is supplied explicitly: the deflection diverges like
    -log(b - b_c) at the critical impact parameter, and giving the network
    the log coordinate resolves that sharp transition without spending
    layers approximating a logarithm (measured: largest single lever on
    the near-critical p95 direction error)."""
    e = entry_c / R
    cross = jnp.cross(e, d_c)
    dot = jnp.sum(e * d_c, axis=-1, keepdims=True)
    # smooth norm: exactly-radial entries have cross = 0, where
    # linalg.norm's 0/0 jacobian would NaN the whole training step
    bmag = jnp.sqrt(jnp.sum(cross * cross, -1, keepdims=True) + 1e-8)
    logb = jnp.log(bmag + 1e-4)
    return jnp.concatenate([
        e[..., 0:1], e[..., 2:3],   # sin/cos of the entry polar angle
        d_c,                         # direction (3)
        cross,                       # impact-parameter vector (3)
        dot,                         # radial approach rate (1)
        bmag, logb,                  # |b|/R and its log (critical-band res.)
    ], axis=-1)


def _straight_exit(entry_c, d_c, R):
    """Flat-space baseline the network predicts RESIDUALS against: a
    straight ray entering the sphere at ``entry_c`` exits at
    entry - 2 (entry . d) d (chord geometry), with unchanged direction.
    The MLP then only has to learn the DEFLECTION — zero output = flat
    spacetime, and the weak-field majority of rays needs only a small
    correction (cuts the escape-direction error several-fold vs predicting
    absolute exit states)."""
    t = -2.0 * jnp.sum(entry_c * d_c, axis=-1, keepdims=True)
    return (entry_c + t * d_c) / R


# =============================================================================
# MLP.
# =============================================================================
def init_params(key, cfg: SurrogateConfig):
    """He-initialized [(W, b), ...] for ``depth`` hidden layers + head."""
    dims = [cfg.n_features] + [cfg.width] * cfg.depth + [cfg.n_outputs]
    params = []
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        key, k = jax.random.split(key)
        w = jax.random.normal(k, (fan_in, fan_out), jnp.float32)
        w = w * jnp.sqrt(2.0 / fan_in)
        params.append((w, jnp.zeros((fan_out,), jnp.float32)))
    return params


def mlp_apply(params, feats, precision: str = "f32"):
    """Dense stack: ``precision='f32'`` runs full float32 (HIGHEST, not
    TF32 -- the accurate default; bf16 activations round the residual head
    at ~4e-3 relative, itself a multi-pixel error floor); ``'bf16'`` is the
    fastest path, for previews."""
    if precision == "bf16":
        h = feats.astype(jnp.bfloat16)
        for w, b in params[:-1]:
            h = jnp.dot(h, w.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32) + b
            h = jax.nn.gelu(h).astype(jnp.bfloat16)
        w, b = params[-1]
        return jnp.dot(h, w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) + b
    h = feats
    for w, b in params[:-1]:
        h = jax.nn.gelu(jnp.dot(h, w, precision=jax.lax.Precision.HIGHEST)
                        + b)
    w, b = params[-1]
    return jnp.dot(h, w, precision=jax.lax.Precision.HIGHEST) + b


# =============================================================================
# The surrogate object (SurrogateTable's trace protocol).
# =============================================================================
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NeuralSurrogate:
    """Trained scattering map with SurrogateTable's ``.trace`` protocol."""

    params: Any       # [(W, b), ...]
    mass: Any         # scalar
    spin: Any         # scalar (0 for Schwarzschild)
    r_influence: Any  # scalar
    # Exit-shell radius R*(1 + exit_tolerance): every escaping ray leaves
    # through this sphere, so predicted exit positions are PROJECTED onto
    # it -- a raw regression can land epsilon inside the influence sphere,
    # and the hybrid renderer's flat re-cast then spuriously re-hits the BH
    # sphere (rendered as the blue/green rogue-ray debug colors).
    r_exit: Any = None
    # Matmul precision ('f32' | 'bf16'); static so jit specializes the path.
    precision: str = dataclasses.field(
        default="f32", metadata=dict(static=True))

    def raw(self, entry, d):
        """Canonical-frame network outputs (dir, loc/R, logit)."""
        entry_c, d_c, phi, flip = canonicalize(entry, d)
        out = mlp_apply(self.params,
                        _features(entry_c, d_c, self.r_influence),
                        self.precision)
        return out, phi, flip

    def trace(self, entry, d):
        """(exit_loc, exit_dir, captured) in BH-centered world coordinates.

        Drop-in for ``SurrogateTable.trace`` (render/limited.py) — the
        jittable twin of the reference surrogate call
        ``aSW.generatedRayTracer(loc_hit, direction)``
        (LimitedRelativisticRenderEngine.py:269)."""
        dn = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
        entry_c, d_c, phi, flip = canonicalize(entry, dn)
        out = mlp_apply(self.params,
                        _features(entry_c, d_c, self.r_influence),
                        self.precision)
        # Residuals on top of the straight-line chord (see _straight_exit).
        exit_dir = d_c + out[..., 0:3]
        exit_dir = exit_dir / jnp.maximum(
            jnp.linalg.norm(exit_dir, axis=-1, keepdims=True), 1e-20)
        exit_loc = (_straight_exit(entry_c, d_c, self.r_influence)
                    + out[..., 3:6]) * self.r_influence
        # Project onto the exit shell (see the r_exit field comment).
        r_exit = (self.r_exit if self.r_exit is not None
                  else 1.1 * self.r_influence)
        exit_loc = exit_loc * (r_exit / jnp.maximum(
            jnp.linalg.norm(exit_loc, axis=-1, keepdims=True), 1e-20))
        captured = out[..., 6] > 0.0
        return (decanonicalize(exit_loc, phi, flip),
                decanonicalize(exit_dir, phi, flip),
                captured)

    def capture_prob(self, entry, d):
        out, _, _ = self.raw(entry, d)
        return jax.nn.sigmoid(out[..., 6])


# =============================================================================
# Labeling with the real integrator.
# =============================================================================
def _label_env(mass, spin, cfg: SurrogateConfig) -> GeodesicEnv:
    from .kerr import horizon_radius

    mass = jnp.asarray(mass, jnp.float32)
    if spin is None:
        r_cap, sp = 2.0 * mass, None
    else:
        sp = jnp.asarray(spin, jnp.float32)
        r_cap = horizon_radius(mass, sp)
        sp = None if float(spin) == 0.0 else sp
    return GeodesicEnv(
        mass=mass,
        r_capture=r_cap,
        r_escape=jnp.asarray(cfg.r_influence * (1.0 + cfg.exit_tolerance),
                             jnp.float32),
        lam_max=jnp.asarray(cfg.lam_max, jnp.float32),
        spin=sp,
    )


def label_rays(env: GeodesicEnv, cfg: SurrogateConfig, entry, d):
    """Integrate (entry, d) to termination: the training-label oracle.

    Returns (captured, exit_loc, exit_dir, escaped_mask).  BUDGET rays
    (affine budget exhausted, long orbiters hugging the photon shell) are
    in NEITHER mask: their true fate is unresolved at this n_steps/lam_max,
    and the exact hybrid engine classifies them as integration errors (RED
    debug pixels, render/limited.py), not captures -- so they are excluded
    from the capture BCE rather than trained as black (they are already
    masked out of the escape regression by ``escaped``)."""
    icfg = IntegratorConfig(n_steps=cfg.n_steps, dt=cfg.dt,
                            dt_boost=cfg.dt_boost, backend=cfg.backend)
    # Nudge inward so the entry shell itself doesn't trip r_escape.
    s = launch(env, entry * (1.0 - 1e-4), d, icfg)
    captured = ((s.status == states.CAPTURED)
                | (s.status == states.INSIDE_HORIZON))
    escaped = s.status == states.ESCAPED
    # Sanitize: a Kerr capture can freeze arbitrarily close to the ring
    # singularity (rho ~ a, z ~ 0), where xdot overflows and the final
    # direction is NaN.  Those rays are excluded from every regression
    # term by the escaped mask, but masking multiplies by 0 and
    # 0 * NaN = NaN would still poison the whole gradient.
    fin_d = final_direction(env, s)
    fin_d = jnp.where(jnp.isfinite(fin_d), fin_d, 0.0)
    x_fin = jnp.where(jnp.isfinite(s.x), s.x, 0.0)
    return captured, x_fin, fin_d, escaped


def sample_entries(key, n, cfg: SurrogateConfig, mass):
    """Entry states on the influence sphere: uniform positions, mixed
    impact-parameter directions.

    Uniform inward directions put only ~(b_c/R)^2 ~ 2% of rays inside the
    capture cone, starving the classifier; half of each batch therefore
    importance-samples the impact parameter b uniformly in [0, 8M]
    (bracketing the critical b_c = 3 sqrt(3) M ~ 5.2 M and the strong-field
    spiral region where the deflection diverges)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    R = cfg.r_influence
    entry = jax.random.normal(k1, (n, 3), jnp.float32)
    entry = R * entry / jnp.linalg.norm(entry, axis=-1, keepdims=True)
    inward = -entry / R

    # Branch A: uniform direction on the inward hemisphere.
    d_uni = jax.random.normal(k2, (n, 3), jnp.float32)
    d_uni = d_uni / jnp.linalg.norm(d_uni, axis=-1, keepdims=True)
    s = jnp.sign(jnp.sum(d_uni * inward, axis=-1, keepdims=True))
    d_uni = d_uni * jnp.where(s == 0, 1.0, s)

    # Branch B: direction at angle alpha = asin(b/R) from the inward
    # radial, azimuth uniform, with b ~ U[0, 8M].
    b = jax.random.uniform(k3, (n,), jnp.float32, 0.0, 8.0 * mass)
    alpha = jnp.arcsin(jnp.clip(b / R, 0.0, 1.0))
    psi = jax.random.uniform(k4, (n,), jnp.float32, 0.0, 2.0 * jnp.pi)
    # Orthonormal frame (inward, u, v) per ray.
    ref = jnp.where(jnp.abs(inward[..., 0:1]) < 0.9,
                    jnp.asarray([1.0, 0.0, 0.0]),
                    jnp.asarray([0.0, 1.0, 0.0]))
    u = jnp.cross(inward, ref)
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    v = jnp.cross(inward, u)
    d_imp = (jnp.cos(alpha)[..., None] * inward
             + (jnp.sin(alpha) * jnp.cos(psi))[..., None] * u
             + (jnp.sin(alpha) * jnp.sin(psi))[..., None] * v)

    pick = jax.random.bernoulli(k5, 0.5, (n, 1))
    return entry, jnp.where(pick, d_imp, d_uni)


# =============================================================================
# Training.
# =============================================================================
def surrogate_loss(params, cfg: SurrogateConfig, R, entry, d,
                   captured, exit_loc, exit_dir, escaped):
    """BCE on capture + masked regression on the escape state."""
    entry_c, d_c, phi, flip = canonicalize(entry, d)
    out = mlp_apply(params, _features(entry_c, d_c, R), cfg.precision)
    # Targets in the canonical frame (same transform as the inputs).
    sgn = jnp.where(flip, -1.0, 1.0)
    rot = _rz(-phi)

    def to_canon(v):
        v = _rotate(rot, v)
        return v.at[..., 2].multiply(sgn)

    # Residual targets relative to the straight-line chord baseline
    # (_straight_exit): zero network output == flat spacetime.  Exit-point
    # labels are projected onto the exit shell first (the integrator stops
    # up to one step PAST r_escape; that radial overshoot is noise the
    # network must not spend capacity on -- inference projects too).
    r_exit = R * (1.0 + cfg.exit_tolerance)
    exit_loc = exit_loc * (r_exit / jnp.maximum(
        jnp.linalg.norm(exit_loc, axis=-1, keepdims=True), 1e-20))
    dir_t = to_canon(exit_dir) - d_c
    loc_t = to_canon(exit_loc) / R - _straight_exit(entry_c, d_c, R)

    logits = out[..., 6]
    # BCE only over rays with a RESOLVED fate; BUDGET/ERROR rays (neither
    # captured nor escaped -- see label_rays) carry no class signal.
    labeled = (captured | escaped).astype(jnp.float32)
    bce = (labeled * optax.sigmoid_binary_cross_entropy(
        logits, captured.astype(jnp.float32))).sum() / jnp.maximum(
        labeled.sum(), 1.0)

    m = escaped.astype(jnp.float32)
    denom = jnp.maximum(m.sum(), 1.0)
    dir_mse = (m * jnp.sum((out[..., 0:3] - dir_t) ** 2, -1)).sum() / denom
    loc_mse = (m * jnp.sum((out[..., 3:6] - loc_t) ** 2, -1)).sum() / denom
    return bce + 10.0 * dir_mse + loc_mse, (bce, dir_mse, loc_mse)


def train_surrogate(key, mass=0.5, spin=0.45, cfg: SurrogateConfig | None = None,
                    steps=2000, batch=8192, lr=3e-3, log_every=0):
    """Train a NeuralSurrogate against the live integrator.

    One jitted step = sample a fresh ray batch -> label it with the real
    (RK4 kernel on a GPU) integrator under ``stop_gradient`` -> one adamw update
    on the MLP.  Infinite fresh data; the integrator IS the dataset.

    Returns (NeuralSurrogate, history dict of per-log losses)."""
    cfg = cfg or SurrogateConfig()
    env = _label_env(mass, spin, cfg)
    R = jnp.asarray(cfg.r_influence, jnp.float32)
    mass_f = float(mass)

    params = init_params(key, cfg)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, max(steps // 20, 1), steps, lr * 1e-2)
    opt = optax.adamw(sched, weight_decay=1e-5)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        key, ks = jax.random.split(key)
        entry, d = sample_entries(ks, batch, cfg, mass_f)
        captured, exit_loc, exit_dir, escaped = jax.lax.stop_gradient(
            label_rays(env, cfg, entry, d))
        (loss, aux), grads = jax.value_and_grad(surrogate_loss, has_aux=True)(
            params, cfg, R, entry, d, captured, exit_loc, exit_dir, escaped)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, key, loss, aux

    history = {"loss": [], "bce": [], "dir_mse": [], "loc_mse": []}
    for i in range(steps):
        params, opt_state, key, loss, aux = step(params, opt_state, key)
        if log_every and (i % log_every == 0 or i == steps - 1):
            history["loss"].append(float(loss))
            history["bce"].append(float(aux[0]))
            history["dir_mse"].append(float(aux[1]))
            history["loc_mse"].append(float(aux[2]))
    if not history["loss"]:
        history["loss"].append(float(loss))

    sur = NeuralSurrogate(
        params=params,
        mass=jnp.asarray(mass, jnp.float32),
        spin=jnp.asarray(0.0 if spin is None else spin, jnp.float32),
        r_influence=R,
        r_exit=jnp.asarray(cfg.r_influence * (1.0 + cfg.exit_tolerance),
                           jnp.float32),
        precision=cfg.precision,
    )
    return sur, history


def evaluate_surrogate(key, sur: NeuralSurrogate, cfg: SurrogateConfig,
                       n=65536):
    """Held-out accuracy vs the integrator on a fresh batch.

    Returns dict: capture accuracy, median/p95 escape-direction error (rad,
    over rays both truth and surrogate call escaped), median exit-position
    error (units of M)."""
    spin = float(sur.spin)
    env = _label_env(float(sur.mass), spin if spin != 0.0 else None, cfg)
    entry, d = sample_entries(key, n, cfg, float(sur.mass))
    captured, exit_loc, exit_dir, escaped = label_rays(env, cfg, entry, d)
    ploc, pdir, pcap = sur.trace(entry, d)

    # accuracy over rays with a RESOLVED fate (BUDGET orbiters are in
    # neither class -- see label_rays -- and are excluded from training)
    labeled = captured | escaped
    cap_acc = float(jnp.sum(((pcap == captured) & labeled).astype(
        jnp.float32)) / jnp.maximum(jnp.sum(labeled.astype(jnp.float32)),
                                    1.0))
    both = escaped & ~pcap
    cosang = jnp.clip(jnp.sum(pdir * exit_dir, -1), -1.0, 1.0)
    ang = jnp.where(both, jnp.arccos(cosang), jnp.nan)
    # compare exit POINTS on the shell (labels overshoot r_escape by up to
    # one step; both sides projected, mirroring trace/loss)
    r_exit = cfg.r_influence * (1.0 + cfg.exit_tolerance)
    exit_loc = exit_loc * (r_exit / jnp.maximum(
        jnp.linalg.norm(exit_loc, axis=-1, keepdims=True), 1e-20))
    locerr = jnp.where(both, jnp.linalg.norm(ploc - exit_loc, axis=-1),
                       jnp.nan)
    ang_np = np.asarray(ang)
    return {
        "capture_acc": cap_acc,
        "dir_err_median_rad": float(np.nanmedian(ang_np)),
        "dir_err_p95_rad": float(np.nanpercentile(ang_np, 95)),
        "loc_err_median": float(np.nanmedian(np.asarray(locerr))),
        "escaped_frac": float(jnp.mean(escaped.astype(jnp.float32))),
    }


# =============================================================================
# Persistence (the reference reloads its surrogate when tolerance/ratio
# change, LimitedRelativisticRenderEngine.py:96-101 — here: save/load npz).
# =============================================================================
def save_surrogate(path, sur: NeuralSurrogate):
    r_exit = (sur.r_exit if sur.r_exit is not None
              else 1.1 * sur.r_influence)
    flat = {"mass": np.asarray(sur.mass), "spin": np.asarray(sur.spin),
            "r_influence": np.asarray(sur.r_influence),
            "r_exit": np.asarray(r_exit),
            "depth": np.asarray(len(sur.params) - 1),
            "precision": np.asarray(sur.precision)}
    for i, (w, b) in enumerate(sur.params):
        flat[f"w{i}"] = np.asarray(w)
        flat[f"b{i}"] = np.asarray(b)
    np.savez(path, **flat)


def load_surrogate(path) -> NeuralSurrogate:
    z = np.load(path)
    depth = int(z["depth"])
    params = [(jnp.asarray(z[f"w{i}"]), jnp.asarray(z[f"b{i}"]))
              for i in range(depth + 1)]
    n_feat = int(params[0][0].shape[0])
    want = SurrogateConfig().n_features
    if n_feat != want:
        raise ValueError(
            f"surrogate {path!r} was trained with {n_feat} input features "
            f"but this version uses {want} (the feature set gained "
            f"|b|/log|b| in round 5); retrain with "
            f"`bhgc-tpu train-surrogate` or models.surrogate"
            f".train_surrogate")
    r_exit = (jnp.asarray(z["r_exit"]) if "r_exit" in z.files
              else 1.1 * jnp.asarray(z["r_influence"]))
    # npz files predating the precision field were trained in bf16
    precision = (str(z["precision"]) if "precision" in z.files else "bf16")
    return NeuralSurrogate(
        params=params,
        mass=jnp.asarray(z["mass"]),
        spin=jnp.asarray(z["spin"]),
        r_influence=jnp.asarray(z["r_influence"]),
        r_exit=r_exit,
        precision=precision,
    )
