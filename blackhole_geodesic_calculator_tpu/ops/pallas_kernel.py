"""Fused RK4 geodesic integration: a Pallas kernel for NVIDIA GPUs (Triton).

The XLA path (``integrate.integrate_fixed``) is a ``lax.scan`` that reads
and writes the whole ray state in device memory at every step and runs every
step for every ray.  This kernel runs the WHOLE integration of a block of
rays inside one program:

* **one ray per thread**: the state is ten 1-D component blocks
  (x0, x1, x2, p0, p1, p2, E, lam, status, hit_obj) of ``block`` rays, held
  in registers for all ``n_steps`` steps; device memory is read once and
  written once;
* **per-block early exit**: the step loop runs in chunks, and a chunk is
  skipped (``lax.cond`` on a block-wide reduction) once every ray of the
  block has stopped;
* scalars (mass, step schedule, termination radii, disk, spin) and the
  sphere table come in as small whole-array inputs.

**Gradient**: ``jax.custom_vjp``.  The backward pass is XLA's vjp of the
checkpointed RK4 segments of ``integrate_fixed``, so the gradient is the
reference's exact discrete adjoint.  The forward rule runs the kernel with
``ckpt=True``: it also writes the state before every remat segment, and the
backward pass recomputes each segment from those checkpoints in reverse.

The step physics mirrors ``ops/integrate.py`` (the reference implementation
and the CPU path); tests enforce parity.  Kerr (spin != None) uses a
hand-derived analytic Kerr-Schild RHS, the component twin of
``native/src/geodesic.cpp``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import states
from .integrate import _fixed_step, _segments

_INF = jnp.inf

# Scalar-parameter vector, padded to a power of two for Triton:
# [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
NSCAL = 16
_N_USED = 10


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _any(mask):
    """Block-wide any(); Triton lowers integer max but not a boolean or."""
    return jnp.max(mask.astype(jnp.int32)) > 0


# =============================================================================
# The step, on 1-D component blocks (pure jnp: also runs on plain arrays).
# =============================================================================
def _rhs_schw_soa(mass, E):
    """Component Schwarzschild-KS Hamiltonian RHS (geodesic.schwarzschild_rhs)."""

    def rhs(a0, a1, a2, b0, b1, b2):
        r2 = jnp.maximum(a0 * a0 + a1 * a1 + a2 * a2, 1e-12)
        inv_r = lax.rsqrt(r2)
        inv_r2 = inv_r * inv_r
        n0, n1, n2 = a0 * inv_r, a1 * inv_r, a2 * inv_r
        u = (2.0 * mass) * inv_r
        s = n0 * b0 + n1 * b1 + n2 * b2
        w = E + s
        uw = u * w
        m_r2 = mass * inv_r2
        cp = 2.0 * m_r2 * w
        cn = m_r2 * w * (w + 2.0 * s)
        return (b0 - uw * n0, b1 - uw * n1, b2 - uw * n2,
                cp * b0 - cn * n0, cp * b1 - cn * n1, cp * b2 - cn * n2)

    return rhs


def _rhs_kerr_soa(mass, spin, E):
    """Analytic Kerr-Schild RHS: dp = +d/dx [H w^2] with the gradient
    hand-derived via implicit differentiation of the KS radius
    (dr/dx_i = (r^2 x_i + a^2 z delta_i2)/(r S), S = 2r^2 - (rho^2-a^2))
    -- the component twin of native/src/geodesic.cpp::rhs, ~2x cheaper than
    per-step jax.grad of the potential (verified equal in tests)."""

    def rhs(a0, a1, a2, b0, b1, b2):
        rho2 = a0 * a0 + a1 * a1 + a2 * a2
        bq = rho2 - spin * spin
        S = jnp.sqrt(bq * bq + 4.0 * spin * spin * a2 * a2)
        r2 = jnp.maximum(0.5 * (bq + S), 1e-12)
        r = jnp.sqrt(r2)
        inv_rS = 1.0 / jnp.maximum(r * S, 1e-12)
        az = spin * spin * a2
        dr0 = r2 * a0 * inv_rS
        dr1 = r2 * a1 * inv_rS
        dr2 = (r2 * a2 + az) * inv_rS

        A = r2 + spin * spin
        inv_A = 1.0 / A
        l0 = (r * a0 + spin * a1) * inv_A
        l1 = (r * a1 - spin * a0) * inv_A
        l2 = a2 / r
        D = r2 * r2 + az * a2
        inv_D = 1.0 / D
        H = mass * r * r2 * inv_D

        w = E + l0 * b0 + l1 * b1 + l2 * b2
        q = 2.0 * H

        # dH/dx_i = M(3 r^2 D - 4 r^6) dr_i / D^2 - 2 M a^2 z r^3 d_i2 / D^2
        hcoef = mass * (3.0 * r2 * D - 4.0 * r2 * r2 * r2) * inv_D * inv_D
        dH0 = hcoef * dr0
        dH1 = hcoef * dr1
        dH2 = hcoef * dr2 - 2.0 * mass * az * r * r2 * inv_D * inv_D

        # dw_i = b_j dl_j/dx_i (quotient rule; dA/dx_i = 2 r dr_i)
        twoR_A2 = 2.0 * r * inv_A * inv_A
        n0 = r * a0 + spin * a1
        n1 = r * a1 - spin * a0
        inv_r2 = 1.0 / r2
        dw0 = (b0 * ((dr0 * a0 + r) * inv_A - n0 * twoR_A2 * dr0)
               + b1 * ((dr0 * a1 - spin) * inv_A - n1 * twoR_A2 * dr0)
               + b2 * (-a2 * dr0 * inv_r2))
        dw1 = (b0 * ((dr1 * a0 + spin) * inv_A - n0 * twoR_A2 * dr1)
               + b1 * ((dr1 * a1 + r) * inv_A - n1 * twoR_A2 * dr1)
               + b2 * (-a2 * dr1 * inv_r2))
        dw2 = (b0 * (dr2 * a0 * inv_A - n0 * twoR_A2 * dr2)
               + b1 * (dr2 * a1 * inv_A - n1 * twoR_A2 * dr2)
               + b2 * (1.0 / r - a2 * dr2 * inv_r2))

        w2 = w * w
        qw = q * w
        return (b0 - qw * l0, b1 - qw * l1, b2 - qw * l2,
                w2 * dH0 + qw * dw0, w2 * dH1 + qw * dw1,
                w2 * dH2 + qw * dw2)

    return rhs


def _ks_radius_soa(spin):
    def ks_r(a0, a1, a2):
        """Kerr-Schild radius (models/kerr.ks_radius, component form)."""
        rho2 = a0 * a0 + a1 * a1 + a2 * a2
        bq = rho2 - spin * spin
        r2 = 0.5 * (bq + jnp.sqrt(bq * bq + 4.0 * spin * spin * a2 * a2))
        return jnp.sqrt(jnp.maximum(r2, 1e-12))

    return ks_r


def _dt_soa(a0, a1, a2, active, scal, kerr, power):
    """Per-ray step size: radius-proportional growth (integrate._dt_eff)."""
    dt0, boost, r_ref = scal[1], scal[2], scal[3]
    if kerr:
        ra = _ks_radius_soa(scal[9])(a0, a1, a2)
    else:
        ra = jnp.sqrt(a0 * a0 + a1 * a1 + a2 * a2)
    dt = jnp.where(active, dt0, 0.0)
    ratio = ra / r_ref
    if power == 1.5:            # sqrt form of the common super-linear case
        ratio = ratio * jnp.sqrt(jnp.maximum(ratio, 0.0))
    elif power == 2.0:
        ratio = ratio * ratio
    elif power != 1.0:
        ratio = jnp.maximum(ratio, 1e-20) ** power
    return dt * jnp.clip(ratio, 1.0, boost)


def _events_merge(xp, cand, dt, lam, status, hit_obj, scal, sph, *,
                  has_disk, n_sph, kerr):
    """Event detection + classification + freeze-merge of one step
    candidate ``cand`` = (y0..q2) from state ``xp`` = (x0..p2, E); mirrors
    integrate._apply_events (kept in lockstep; parity is tested).
    ``sph`` is the flat sphere table (cx, cy, cz, radius) * n_sph.

    The K-sphere quadratic tests sit behind a block-uniform ``lax.cond``
    on a CONSERVATIVE radius-shell possibility test: every point of the
    segment x -> y lies within L = |y - x| of y, so sphere k (surface radii
    [|c_k|-rad_k, |c_k|+rad_k]) can only be hit when [|y|-L, |y|+L]
    overlaps that band.  Blocks integrating in the strong field or the far
    approach skip the whole K-sphere block; results are bit-identical by
    construction (the skipped branch returns the no-hit defaults)."""
    x0, x1, x2, p0, p1, p2, E = xp
    y0, y1, y2, q0, q1, q2 = cand
    r_cap, r_esc, lam_max = scal[4], scal[5], scal[6]
    spin = scal[9]
    active = status == states.ACTIVE

    # endpoint radius; computed first so the sphere guard can reuse it
    if kerr:
        rb = _ks_radius_soa(spin)(y0, y1, y2)
    else:
        rb = jnp.sqrt(y0 * y0 + y1 * y1 + y2 * y2)

    # --- events on the segment (x -> y); integrate._apply_events ----------
    disk_p0 = disk_p1 = None
    t_disk = jnp.full_like(x0, _INF)
    if has_disk:
        crossed = ((y2 < 0) & (x2 >= 0)) | ((y2 > 0) & (x2 <= 0))
        denom = y2 - x2
        t = -x2 / jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        d0p = x0 + (y0 - x0) * t
        d1p = x1 + (y1 - x1) * t
        rr = jnp.sqrt(d0p * d0p + d1p * d1p)
        disk_hit = crossed & (rr >= scal[7]) & (rr <= scal[8])
        t_disk = jnp.where(disk_hit, t, _INF)
        disk_p0, disk_p1 = d0p, d1p

    t_sph = jnp.full_like(x0, _INF)
    sph_id = jnp.full_like(status, -1)
    if n_sph:
        dx0, dx1, dx2 = y0 - x0, y1 - x1, y2 - x2
        aa = dx0 * dx0 + dx1 * dx1 + dx2 * dx2

        def sphere_tests(_):
            denom_a = jnp.where(aa > 0, 2.0 * aa, 1.0)
            ts, ids = t_sph, sph_id
            for k in range(n_sph):
                cx, cy, cz, rad = sph[4 * k:4 * k + 4]
                o0, o1, o2 = x0 - cx, x1 - cy, x2 - cz
                bb = 2.0 * (o0 * dx0 + o1 * dx1 + o2 * dx2)
                cc = o0 * o0 + o1 * o1 + o2 * o2 - rad * rad
                disc = bb * bb - 4.0 * aa * cc
                # guarded sqrt: integrate._sphere_events (NaN-jacobian trap)
                sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
                t = (-bb - sq) / denom_a
                valid = (disc > 0) & (t >= 0.0) & (t <= 1.0) & (t < ts)
                ts = jnp.where(valid, t, ts)
                ids = jnp.where(valid, k, ids)
            return ts, ids

        # The sphere geometry is EUCLIDEAN; rb is reused as the radius
        # proxy: for Schwarzschild rb IS |y|, for Kerr the KS radius
        # brackets it as rb <= |y| <= sqrt(rb^2 + a^2) <= rb + |a|, so
        # widening the band by |a| stays conservative without a second sqrt.
        L = jnp.sqrt(aa)
        slack = jnp.abs(spin) if kerr else 0.0
        possible = jnp.zeros_like(active)
        for k in range(n_sph):
            cx, cy, cz, rad = sph[4 * k:4 * k + 4]
            ck = jnp.sqrt(cx * cx + cy * cy + cz * cz)
            possible = possible | ((rb - L <= ck + rad)
                                   & (rb + slack + L >= ck - rad))
        t_sph, sph_id = lax.cond(_any(possible & active), sphere_tests,
                                 lambda _: (t_sph, sph_id), None)

    # --- endpoint classification ------------------------------------------
    lam1 = lam + dt
    finite = (
        jnp.isfinite(y0) & jnp.isfinite(y1) & jnp.isfinite(y2)
        & jnp.isfinite(q0) & jnp.isfinite(q1) & jnp.isfinite(q2)
    )
    st = jnp.where(lam1 >= lam_max, states.BUDGET, states.ACTIVE)
    st = jnp.where(rb >= r_esc, states.ESCAPED, st)
    st = jnp.where(rb <= r_cap, states.CAPTURED, st)
    st = jnp.where(~finite, states.ERROR, st)
    if n_sph:
        st = jnp.where(jnp.isfinite(t_sph), states.OBJECT, st)
    if has_disk:
        disk_wins = jnp.isfinite(t_disk) & (t_disk <= t_sph)
        st = jnp.where(disk_wins, states.DISK, st)
    st = jnp.where(active, st, status)

    # --- merge; event rays freeze AT the interpolated event point ---------
    upd = active & finite
    y0 = jnp.where(upd, y0, x0)
    y1 = jnp.where(upd, y1, x1)
    y2 = jnp.where(upd, y2, x2)
    q0 = jnp.where(upd, q0, p0)
    q1 = jnp.where(upd, q1, p1)
    q2 = jnp.where(upd, q2, p2)
    lam1 = jnp.where(active, lam1, lam)
    obj1 = hit_obj
    if n_sph:
        sel = active & (st == states.OBJECT)
        ts = jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)
        # x here is the pre-step state; y was overwritten only for frozen
        # rays (sel implies active & finite, so y is the raw RK4 endpoint)
        y0 = jnp.where(sel, x0 + dx0 * ts, y0)
        y1 = jnp.where(sel, x1 + dx1 * ts, y1)
        y2 = jnp.where(sel, x2 + dx2 * ts, y2)
        lam1 = jnp.where(sel, lam + dt * ts, lam1)
        obj1 = jnp.where(sel, sph_id, hit_obj)
    if has_disk:
        sel = active & (st == states.DISK)
        td = jnp.where(jnp.isfinite(t_disk), t_disk, 0.0)
        y0 = jnp.where(sel, disk_p0, y0)
        y1 = jnp.where(sel, disk_p1, y1)
        y2 = jnp.where(sel, jnp.zeros_like(y2), y2)
        lam1 = jnp.where(sel, lam + dt * td, lam1)

    return (y0, y1, y2, q0, q1, q2, E), lam1, st, obj1


def _soa_step(xp, lam, status, hit_obj, scal, sph, *, has_disk, n_sph,
              kerr=False, power=1.0):
    """One RK4 step + event handling on 1-D component blocks.

    Mirrors integrate._fixed_step + _apply_events (kept in lockstep; parity
    is tested).  Returns ((x0..p2, E), lam1, status1, hit_obj1).
    ``kerr=True`` switches the RHS to the Kerr-Schild family with spin
    ``a = scal[9]`` and the termination/step radius to the KS radius.
    """
    x0, x1, x2, p0, p1, p2, E = xp
    mass, spin = scal[0], scal[9]
    active = status == states.ACTIVE
    h = _dt_soa(x0, x1, x2, active, scal, kerr, power)
    rhs = (_rhs_kerr_soa(mass, spin, E) if kerr
           else _rhs_schw_soa(mass, E))

    def axpy(c, ks):
        return (x0 + c * ks[0], x1 + c * ks[1], x2 + c * ks[2],
                p0 + c * ks[3], p1 + c * ks[4], p2 + c * ks[5])

    ka = rhs(x0, x1, x2, p0, p1, p2)
    kb = rhs(*axpy(0.5 * h, ka))
    kc = rhs(*axpy(0.5 * h, kb))
    kd = rhs(*axpy(h, kc))
    s6 = h * (1.0 / 6.0)
    cand = tuple(v + s6 * (ka[i] + 2.0 * (kb[i] + kc[i]) + kd[i])
                 for i, v in enumerate((x0, x1, x2, p0, p1, p2)))
    return _events_merge(xp, cand, h, lam, status, hit_obj, scal, sph,
                         has_disk=has_disk, n_sph=n_sph, kerr=kerr)


# =============================================================================
# The kernel.
# =============================================================================
def _kernel(scal_ref, sph_ref,
            x0r, x1r, x2r, p0r, p1r, p2r, Er, lamr, str_, objr,
            ox0, ox1, ox2, op0, op1, op2, olam, ost, oobj, *ck_refs,
            n_steps, chunk, has_disk, n_sph, kerr, power):
    """Integrate one block of rays for ``n_steps`` RK4 steps.

    The steps run in ``chunk``-step chunks; a chunk is skipped once no ray
    of the block is ACTIVE (a skipped chunk costs one block reduction).
    With checkpoint outputs ``ck_refs`` = (x0..p2, lam, status), row ``c``
    of each receives the state before chunk ``c``: one chunk is one remat
    segment of ``integrate_fixed``."""
    scal = tuple(scal_ref[i] for i in range(_N_USED))
    sph = tuple(sph_ref[i] for i in range(4 * n_sph))
    carry0 = ((x0r[...], x1r[...], x2r[...], p0r[...], p1r[...], p2r[...],
               Er[...]), lamr[...], str_[...], objr[...])

    def step(_, c):
        xp, lam, st, obj = c
        return _soa_step(xp, lam, st, obj, scal, sph, has_disk=has_disk,
                         n_sph=n_sph, kerr=kerr, power=power)

    def run_chunk(c, carry):
        if ck_refs:
            xp, lam, st, _ = carry
            for ref, v in zip(ck_refs, (*xp[:6], lam, st)):
                ref[c, :] = v
        length = jnp.minimum(chunk, n_steps - c * chunk)
        return lax.cond(_any(carry[2] == states.ACTIVE),
                        lambda cc: lax.fori_loop(0, length, step, cc),
                        lambda cc: cc, carry)

    xp, lam, st, obj = lax.fori_loop(0, -(-n_steps // chunk), run_chunk,
                                     carry0)
    for ref, v in zip((ox0, ox1, ox2, op0, op1, op2), xp[:6]):
        ref[...] = v
    olam[...], ost[...], oobj[...] = lam, st, obj


# Rays per program, one ray per thread: 4 warps.  A sweep of 32..512 rays
# and 1..16 warps on an H100 moved no variant by more than ~10%.
_DEFAULT_BLOCK = 128
_WARP = 32


def _call(comps, scal, sph, *, n_steps, chunk, has_disk, n_sph, kerr,
          power, block, ckpt, interpret):
    """pallas_call over 1-D component arrays of length ``npad`` (a multiple
    of ``block``).  Returns 9 output arrays, plus 8 checkpoint arrays of
    shape (n_chunks_pad, npad) when ``ckpt``."""
    npad = comps[0].shape[0]
    n_chunks = -(-n_steps // chunk)
    row = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))  # noqa: E731
    f32 = jax.ShapeDtypeStruct((npad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((npad,), jnp.int32)
    out_shape = [f32] * 7 + [i32] * 2
    out_specs = [row] * 9
    if ckpt:
        rows = _pow2(n_chunks)
        out_shape += ([jax.ShapeDtypeStruct((rows, npad), jnp.float32)] * 7
                      + [jax.ShapeDtypeStruct((rows, npad), jnp.int32)])
        out_specs += [pl.BlockSpec((rows, block), lambda i: (0, i))] * 8
    kern = functools.partial(
        _kernel, n_steps=n_steps, chunk=chunk, has_disk=has_disk,
        n_sph=n_sph, kerr=kerr, power=power)
    return pl.pallas_call(
        kern,
        grid=(npad // block,),
        in_specs=[whole(scal), whole(sph)] + [row] * 10,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pltriton.CompilerParams(num_warps=block // _WARP,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rk4_geodesic_fwd_ckpt" if ckpt else "rk4_geodesic_fwd",
    )(scal, sph, *comps)


def _scalars(env, cfg):
    r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
    boost = cfg.dt_boost if cfg.dt_boost > 1.0 else 1.0
    vals = [env.mass, cfg.dt, boost, r_ref, env.r_capture, env.r_escape,
            env.lam_max,
            env.disk.r_in if env.disk is not None else 0.0,
            env.disk.r_out if env.disk is not None else 0.0,
            0.0 if env.spin is None else env.spin]
    vals += [0.0] * (NSCAL - len(vals))
    return jnp.stack([jnp.asarray(v, jnp.float32) for v in vals])


def _sphere_table(env):
    n_sph = 0 if env.spheres is None else int(env.spheres.center.shape[0])
    if not n_sph:
        return 0, jnp.zeros((4,), jnp.float32)
    tab = jnp.concatenate(
        [jnp.asarray(env.spheres.center, jnp.float32),
         jnp.asarray(env.spheres.radius, jnp.float32)[:, None]],
        axis=1).reshape(-1)
    pad = _pow2(4 * n_sph) - 4 * n_sph
    return n_sph, jnp.pad(tab, (0, pad))


def _forward(env, s0, cfg, block, interpret, ckpt):
    """Run the kernel on a flat (N,) batch.  Returns the final RayState and,
    with ``ckpt``, the RayState before every remat segment (leading axis
    n_seg, in ``integrate_fixed``'s segmentation; E and hit_obj are
    copies -- the backward pass reads neither)."""
    n = s0.E.shape[0]
    seg = _segments(cfg)[0]
    chunk = seg if ckpt else min(16, cfg.n_steps)
    pad = (-n) % block
    npad = n + pad

    def pad_to(v, fill=0.0):
        v = v.astype(jnp.int32 if v.dtype == jnp.int32 else jnp.float32)
        return jnp.pad(v, (0, pad), constant_values=fill) if pad else v

    # Padding rays are pre-terminated (ERROR status) so they cost nothing;
    # they sit far from the hole so no step of theirs could ever overflow.
    comps = [pad_to(s0.x[:, 0], 1e3), pad_to(s0.x[:, 1]),
             pad_to(s0.x[:, 2]), pad_to(s0.p[:, 0]), pad_to(s0.p[:, 1]),
             pad_to(s0.p[:, 2]), pad_to(s0.E, 1.0), pad_to(s0.lam),
             pad_to(s0.status, states.ERROR), pad_to(s0.hit_obj, -1)]

    n_sph, sph = _sphere_table(env)
    outs = _call(comps, _scalars(env, cfg), sph, n_steps=cfg.n_steps,
                 chunk=chunk, has_disk=env.disk is not None, n_sph=n_sph,
                 kerr=env.spin is not None, power=float(cfg.dt_power),
                 block=block, ckpt=ckpt, interpret=interpret)

    def state(o, E, hit_obj):
        return states.RayState(
            x=jnp.stack(o[0:3], -1).astype(s0.x.dtype),
            p=jnp.stack(o[3:6], -1).astype(s0.p.dtype),
            E=E, lam=o[6].astype(s0.lam.dtype), status=o[7],
            hit_obj=hit_obj)

    out = [o[:n] for o in outs[:9]]
    final = state(out, s0.E, out[8])
    if not ckpt:
        return final, None
    n_seg = -(-cfg.n_steps // seg)
    ck = [o[:n_seg, :n] for o in outs[9:]]
    E_b = jnp.broadcast_to(s0.E, (n_seg, n))
    obj_b = jnp.broadcast_to(s0.hit_obj, (n_seg, n))
    return final, state(ck, E_b, obj_b)


# =============================================================================
# custom_vjp: kernel forward, XLA segment-adjoint backward.
# =============================================================================
def _segment(env, cfg, s, length):
    s, _ = lax.scan(lambda c, _: (_fixed_step(env, cfg, c), None), s, None,
                    length=length)
    return s


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _integrate(env, s0, cfg, block, interpret):
    return _forward(env, s0, cfg, block, interpret, False)[0]


def _integrate_fwd(env, s0, cfg, block, interpret):
    out, ck = _forward(env, s0, cfg, block, interpret, True)
    return out, (env, ck)


def _integrate_bwd(cfg, block, interpret, res, g):
    """Reverse sweep over the kernel's segment checkpoints: each segment's
    vjp is XLA's autodiff of the same RK4 steps ``integrate_fixed`` runs,
    so the result is its exact discrete adjoint."""
    env, ck = res
    seg, n_full, rem = _segments(cfg)
    g_env = jax.tree.map(jnp.zeros_like, env)

    def seg_vjp(carry, s_in, length):
        g_env, g_s = carry
        _, vjp = jax.vjp(lambda e, s: _segment(e, cfg, s, length), env, s_in)
        ge, g_s = vjp(g_s)
        return jax.tree.map(jnp.add, g_env, ge), g_s

    carry = (g_env, g)
    if rem:
        carry = seg_vjp(carry, jax.tree.map(lambda a: a[n_full], ck), rem)
    if n_full:
        carry, _ = lax.scan(
            lambda c, s_in: (seg_vjp(c, s_in, seg), None), carry,
            jax.tree.map(lambda a: a[:n_full], ck), reverse=True)
    return carry


_integrate.defvjp(_integrate_fwd, _integrate_bwd)


def integrate_pallas(env, s0, cfg, *, block: int | None = None,
                     interpret: bool = False):
    """Kernel twin of integrate.integrate_fixed: same env/state/config.

    Any batch shape (leading dims are flattened and restored).  Schwarzschild
    or Kerr, with or without disk and spheres.  Differentiable w.r.t. x, p,
    E and every float of ``env`` (mass, spin, sphere geometry, ...).
    ``block`` rays per program (a power of two >= 32; one ray per thread).
    ``interpret=True`` runs the kernel on the CPU (tests only)."""
    block = block or _DEFAULT_BLOCK
    if block < _WARP or block & (block - 1):
        raise ValueError(f"block must be a power of two >= {_WARP}, "
                         f"got {block}")
    batch = s0.E.shape
    if len(batch) != 1:
        flat = jax.tree.map(
            lambda a: a.reshape((-1,) + a.shape[len(batch):]), s0)
        out = integrate_pallas(env, flat, cfg, block=block,
                               interpret=interpret)
        return jax.tree.map(
            lambda a: a.reshape(batch + a.shape[1:]), out)
    return _integrate(env, s0, cfg, block, interpret)
