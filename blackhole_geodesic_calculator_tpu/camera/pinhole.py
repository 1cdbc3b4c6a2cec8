"""Pinhole camera with jittered multisampling.

Reproduces the reference ray model exactly
(/root/reference/raytracer/RelativisticRenderEngine.py:182-230):

    aspect   = H / W
    x_render = fov_x * (x - W//2) / W
    y_render = fov_y * (y - H//2) / H * aspect
    dir_cam  = (x_render + dx*(u-0.5), y_render + dy*(v-0.5), -1)
    dx, dy   = 1/W, aspect/H                       [jitter amplitudes]
    dir      = normalize(euler_rotate(dir_cam))

with u, v uniform per sample from the seeded RNG (``sampling_seed`` scene
property, :189,509).  Python ``random`` is replaced by counter-based
``jax.random`` so every sample of every pixel is reproducible and
order-independent under any sharding.

The camera looks down -z in its local frame and is oriented by XYZ Euler
angles exactly like Blender's ``direction.rotate(camera.rotation_euler)``
(:229; R = Rz @ Ry @ Rx).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Differentiable camera parameters (position, XYZ euler, fov pair)."""

    position: Any   # (3,)
    euler: Any      # (3,) radians, Blender XYZ order
    fov: Any        # (2,) = (fov_x, fov_y); reference default (1, 1) :510-511

    @classmethod
    def make(cls, position, euler=(0.0, 0.0, 0.0), fov=(1.0, 1.0)):
        f = lambda v: jnp.asarray(v, jnp.float32)
        return cls(position=f(position), euler=f(euler), fov=f(fov))


def euler_matrix(euler: Array) -> Array:
    """Blender 'XYZ' Euler to rotation matrix: R = Rz(c) @ Ry(b) @ Rx(a)."""
    a, b, c = euler[0], euler[1], euler[2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cc, sc = jnp.cos(c), jnp.sin(c)
    rx = jnp.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = jnp.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = jnp.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    hi = lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(rz, ry, precision=hi), rx, precision=hi)


def pixel_grid(width: int, height: int,
               x_min: int = 0, x_max: int | None = None,
               y_min: int = 0, y_max: int | None = None):
    """Integer pixel coordinates of the (cropped) render window.

    The crop window mirrors the reference's mark_x/y_min/max debug rectangle
    (RelativisticRenderEngine.py:106-118,199,219).  Returns (ys, xs) each of
    shape (Hc, Wc).
    """
    x_max = width if x_max is None else x_max
    y_max = height if y_max is None else y_max
    ys = jnp.arange(y_min, y_max)
    xs = jnp.arange(x_min, x_max)
    return jnp.meshgrid(ys, xs, indexing="ij")


def generate_rays(cam: Camera, width: int, height: int, ys: Array, xs: Array,
                  key: Array | None = None) -> tuple[Array, Array]:
    """Ray origins (broadcast) and unit directions for pixel centers (ys, xs).

    ``key`` enables the reference's uniform +-dx/2, +-dy/2 jitter; None gives
    deterministic pixel centers (the s=0 sample convention for golden tests).
    """
    aspect = height / width
    x_render = cam.fov[0] * (xs - width // 2) / width
    y_render = cam.fov[1] * (ys - height // 2) / height * aspect
    if key is not None:
        ju, jv = jax.random.uniform(key, (2,) + xs.shape) - 0.5
        x_render = x_render + ju / width
        y_render = y_render + jv * aspect / height
    d_cam = jnp.stack(
        [x_render, y_render, -jnp.ones_like(x_render)], axis=-1
    )
    rot = euler_matrix(cam.euler)
    # full f32: a GPU may run a default-precision f32 product in TF32
    # (~3 decimal digits), coarser than one flagship pixel (7.8e-4 rad)
    d = jnp.matmul(d_cam, rot.T, precision=lax.Precision.HIGHEST)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.position, d.shape)
    return o, d
