"""Differentiable texture sampling.

The reference leans on Blender's CPU texture engine --
``bpy.data.textures[...].evaluate((x, y, 0))`` with coordinates in the
[-1, 1] box (background lookup at
/root/reference/raytracer/RelativisticRenderEngine.py:375, disk lookup at
LimitedRelativisticRenderEngine.py:434, moon UV at :357) -- costing a
Python<->C++ FFI crossing per pixel.  Here a texture is just a jnp array
(H, W, 3) and sampling is a batched bilinear gather: differentiable w.r.t.
the texture contents (texture optimization/inverse rendering) and fused by
XLA into the shading program.

Coordinate convention matches ``bpy`` evaluate: x, y in [-1, 1], x wraps
(image textures repeat), y = -1 is the bottom image row.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# arccos has an infinite derivative at +-1; rays aligned with the poles (the
# exact center pixel of a hole-centered camera, radial rays) would poison
# gradients through jnp.where (the unselected branch still differentiates).
_ACOS_EPS = 1e-6


def safe_arccos(x: Array) -> Array:
    return jnp.arccos(jnp.clip(x, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))


def safe_arctan2(y: Array, x: Array) -> Array:
    """atan2 whose gradient is finite at (0, 0) -- exactly polar directions
    (radial rays through the camera axis) have undefined azimuth anyway."""
    deg = (jnp.abs(x) < _ACOS_EPS) & (jnp.abs(y) < _ACOS_EPS)
    return jnp.arctan2(jnp.where(deg, 0.0, y), jnp.where(deg, 1.0, x))


def _bilinear_setup(tex, x, y):
    """Shared corner indices + fractional weights of a bpy-coord sample."""
    h, w = tex.shape[0], tex.shape[1]
    # [-1, 1] -> continuous pixel coords; y flipped (row 0 is the top).
    fx = (x + 1.0) * 0.5 * w - 0.5
    fy = (1.0 - y) * 0.5 * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    xi0 = jnp.mod(x0, w)
    xi1 = jnp.mod(x0 + 1, w)
    yi0 = jnp.clip(y0, 0, h - 1)
    yi1 = jnp.clip(y0 + 1, 0, h - 1)
    return xi0, xi1, yi0, yi1, tx, ty


def _sample_corners(tex, xi0, xi1, yi0, yi1):
    return tex[yi0, xi0], tex[yi0, xi1], tex[yi1, xi0], tex[yi1, xi1]


@jax.custom_vjp
def sample_bpy(tex: Array, x: Array, y: Array) -> Array:
    """Bilinear sample at bpy-style coords; tex (H, W, C), x/y (...,).

    Custom VJP, written for an earlier accelerator whose scatter and
    gather units were slow; it still runs on the GPU and awaits
    measurement there against plain autodiff:

    * The autodiff transpose of the 4 corner gathers is a scatter-add with
      duplicate indices over 4N updates.  The handwritten backward
      exploits the FIXED 2x2 footprint: all four corners share the base
      cell (y0, x0), so ONE N-update scatter of a 12-channel payload
      (4 corners x C) lands everything, and the corner offsets are resolved
      densely afterwards -- a roll in x (wrap = the mod-W corner) and a
      row fold in y (the clip-to-edge corner); bit-identical modulo f32
      addition order.
    * The corner colors are saved as residuals so the backward re-issues no
      gathers.
    """
    out, _ = _sample_bpy_fwd(tex, x, y)
    return out


# The quad-texture gather/scatter fast path materializes a 4x copy of the
# texture; past this footprint (transient HBM) fall back to plain 4-corner
# gathers/scatters -- an 8k f32 equirect (~400 MB) must not allocate ~1.6 GB
# per lookup site.
_QUAD_LIMIT_BYTES = 64 * 2 ** 20


def _use_quad(tex) -> bool:
    h, w, c = tex.shape
    return 4 * h * w * c * tex.dtype.itemsize <= _QUAD_LIMIT_BYTES


def _sample_bpy_fwd(tex, x, y):
    h, w = tex.shape[0], tex.shape[1]
    c = tex.shape[2]
    fx = (x + 1.0) * 0.5 * w - 0.5
    fy = (1.0 - y) * 0.5 * h - 0.5
    x0f = jnp.floor(fx)
    y0f = jnp.floor(fy)
    tx = fx - x0f
    ty = fy - y0f
    x0 = x0f.astype(jnp.int32)
    y0u = y0f.astype(jnp.int32)      # unclipped: row fold happens in bwd
    xi0 = jnp.mod(x0, w)

    if _use_quad(tex):
        # Quad texture: row p holds the full 2x2 footprint of base row
        # y0u = p - 1 (rows clipped to the edge, +1 column wrapped), so the
        # four corner colors arrive in ONE gather row of 4C floats instead
        # of four rows of C; the quad build itself is dense and cheap.
        ra = jnp.concatenate([tex[:1], tex], axis=0)      # clip(p-1, 0, h-1)
        rb = jnp.concatenate([tex, tex[-1:]], axis=0)     # clip(p,   0, h-1)
        rolled = lambda t: jnp.roll(t, -1, axis=1)  # 2.4x the sliced concat
        quad = jnp.concatenate(
            [ra, rolled(ra), rb, rolled(rb)], axis=-1)    # (h+1, w, 4C)
        p = jnp.clip(y0u, -1, h - 1) + 1
        q = quad.reshape((h + 1) * w, 4 * c)[p * w + xi0]
        c00, c01, c10, c11 = (q[..., :c], q[..., c:2 * c],
                              q[..., 2 * c:3 * c], q[..., 3 * c:])
    else:
        xi1 = jnp.mod(x0 + 1, w)
        yi0 = jnp.clip(y0u, 0, h - 1)
        yi1 = jnp.clip(y0u + 1, 0, h - 1)
        c00, c01, c10, c11 = (tex[yi0, xi0], tex[yi0, xi1],
                              tex[yi1, xi0], tex[yi1, xi1])

    txe, tye = tx[..., None], ty[..., None]
    top = c00 * (1.0 - txe) + c01 * txe
    bot = c10 * (1.0 - txe) + c11 * txe
    out = top * (1.0 - tye) + bot * tye
    # tex rides along only for its (static) shape/dtype; no backward gather
    # ever touches it.
    res = (tex, c00, c01, c10, c11, tx, ty, y0u, xi0)
    return out, res


def _sample_bpy_bwd(res, g):
    tex, c00, c01, c10, c11, tx, ty, y0u, xi0 = res
    h, w, c = tex.shape
    dtype = tex.dtype
    txe, tye = tx[..., None], ty[..., None]

    if _use_quad(tex):
        # --- d tex: one N-update scatter + dense shifts -------------------
        # Padded row index p in [0, h]: p = clip(y0u, -1, h-1) + 1; equirect
        # coords keep y0u in [-1, h-1] already, the clip guards other uses.
        p = jnp.clip(y0u, -1, h - 1) + 1
        upd = jnp.concatenate(
            [g * (1.0 - txe) * (1.0 - tye), g * txe * (1.0 - tye),
             g * (1.0 - txe) * tye, g * txe * tye], axis=-1)
        S = jnp.zeros(((h + 1) * w, 4 * c), dtype).at[
            (p * w + xi0).reshape(-1)].add(upd.reshape(-1, 4 * c)).reshape(
                h + 1, w, 4, c)

        def fold0(a):  # base row: y = max(y0u, 0); pad row 0 folds into row 0
            b = a[1:]
            return b.at[0].add(a[0])

        def fold1(a):  # next row: y = min(y0u+1, h-1); pad row h folds back
            b = a[:h]
            return b.at[h - 1].add(a[h])

        def rollx(a):  # the +1 column wraps (mod w)
            return jnp.roll(a, 1, axis=1)

        dtex = (fold0(S[:, :, 0]) + rollx(fold0(S[:, :, 1]))
                + fold1(S[:, :, 2]) + rollx(fold1(S[:, :, 3])))
    else:
        # Large texture: 4 plain scatter-adds into (h, w, c) -- no 4x quad
        # copy; slower (sort-based lowering) but memory-safe for 8k skies.
        xi1 = jnp.mod(xi0 + 1, w)
        yi0 = jnp.clip(y0u, 0, h - 1)
        yi1 = jnp.clip(y0u + 1, 0, h - 1)
        dtex = (jnp.zeros((h, w, c), dtype)
                .at[yi0, xi0].add(g * (1.0 - txe) * (1.0 - tye))
                .at[yi0, xi1].add(g * txe * (1.0 - tye))
                .at[yi1, xi0].add(g * (1.0 - txe) * tye)
                .at[yi1, xi1].add(g * txe * tye))

    # --- dx, dy: exactly the autodiff of the bilinear weights ------------
    dfx = jnp.sum(g * ((c01 - c00) * (1.0 - tye) + (c11 - c10) * tye),
                  axis=-1)
    dfy = jnp.sum(g * ((c10 - c00) * (1.0 - txe) + (c11 - c01) * txe),
                  axis=-1)
    dx = dfx * (0.5 * w)
    dy = dfy * (-0.5 * h)
    return dtex, dx, dy


sample_bpy.defvjp(_sample_bpy_fwd, _sample_bpy_bwd)


def sample_equirect(tex: Array, direction: Array) -> Array:
    """Equirectangular environment lookup from a unit direction.

    Exactly the reference mapping (RelativisticRenderEngine.py:373-375):
        theta = 1 - arccos(d_z)/pi
        phi   = atan2(d_y, d_x)/pi
        color = tex.evaluate((-phi, 2*theta - 1))
    """
    theta = 1.0 - safe_arccos(direction[..., 2]) / jnp.pi
    phi = safe_arctan2(direction[..., 1], direction[..., 0]) / jnp.pi
    return sample_bpy(tex, -phi, 2.0 * theta - 1.0)


def sphere_uv_bpy(normal: Array, compat_arctan: bool = True) -> tuple[Array, Array]:
    """Spherical UV of a unit normal, reference emission-shader convention
    (LimitedRelativisticRenderEngine.py:353-357):
        th = arccos(n_z); ph = arctan(n_y/n_x)   [note: arctan, not atan2]
        coords = (ph/(2 pi), th/pi)
    ``compat_arctan=False`` upgrades to atan2 (full 360-degree seamless wrap).
    """
    th = safe_arccos(normal[..., 2])
    if compat_arctan:
        ph = jnp.arctan(normal[..., 1] / jnp.where(
            jnp.abs(normal[..., 0]) > 1e-20, normal[..., 0], 1e-20))
    else:
        ph = jnp.arctan2(normal[..., 1], normal[..., 0])
    return ph / (2.0 * jnp.pi), th / jnp.pi
