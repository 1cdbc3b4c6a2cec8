"""Generic spacetime-metric API.

The reference derives metrics and Christoffel symbols symbolically with sympy
(curvedpy ``SW.g`` / ``SW.gam_y``; see /root/reference/README.md:174-186 and the
Christoffel definition at README.md:133-135).  Here the same contract is provided
natively in JAX: a metric is a pure function ``g(x4) -> (4, 4)`` and the Christoffel
symbols are obtained by *forward-mode autodiff of the metric itself* --

    Gamma^sigma_{mu nu} = 1/2 g^{sigma rho} (d_mu g_{nu rho} + d_nu g_{rho mu}
                                             - d_rho g_{mu nu})

-- which is exact, works for any metric (Schwarzschild, Kerr, flat, ...) and is
traced once under ``jax.jit`` instead of being lambdified per process.

Index/coordinate conventions
----------------------------
* Coordinates are Cartesian-like ``x4 = (t, x, y, z)``; signature (-, +, +, +).
* Geometrized units G = c = 1; the Schwarzschild radius is ``r_s = 2 M``
  (reference comment /root/reference/raytracer/RelativisticRenderEngine.py:95).
* ``k4 = dx4/dlambda`` is the coordinate velocity along the geodesic, affine
  parameter lambda.  The geodesic equation split into first-order form follows
  the reference exactly (README.md:198-209):

      dk^alpha/dlambda = -Gamma^alpha_{mu nu} k^mu k^nu
      dx^beta /dlambda = k^beta
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array
# Tensor contractions in full f32: a GPU may otherwise run f32 products in
# TF32 (~3 decimal digits).
_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Metric:
    """A spacetime metric defined by a pure function ``g_fn(x4, *params)``.

    ``params`` are differentiable pytree leaves (e.g. mass, spin) so gradients
    of rendered images w.r.t. physical parameters flow through the metric.
    """

    g_fn: Callable[..., Array]  # (x4, *params) -> (4, 4)
    params: tuple
    name: str = "generic"
    g_inv_fn: Callable[..., Array] | None = None  # analytic inverse if known

    # -- pytree plumbing (params are traced leaves, the rest is static) -------
    def tree_flatten(self):
        return (self.params,), (self.g_fn, self.name, self.g_inv_fn)

    @classmethod
    def tree_unflatten(cls, aux, children):
        g_fn, name, g_inv_fn = aux
        (params,) = children
        return cls(g_fn=g_fn, params=params, name=name, g_inv_fn=g_inv_fn)

    # -- core API -------------------------------------------------------------
    def g(self, x4: Array) -> Array:
        """Covariant metric tensor g_{mu nu} at ``x4``; shape (4, 4)."""
        return self.g_fn(x4, *self.params)

    def g_inv(self, x4: Array) -> Array:
        """Contravariant metric g^{mu nu}; analytic when available (important
        for f32 accuracy), generic linear-solve fallback otherwise."""
        if self.g_inv_fn is not None:
            return self.g_inv_fn(x4, *self.params)
        return jnp.linalg.inv(self.g(x4))

    def christoffel(self, x4: Array) -> Array:
        """Gamma^sigma_{mu nu} with shape (4, 4, 4), indices [sigma, mu, nu].

        Derived by forward-mode AD of ``g`` -- the batched equivalent of the
        reference's sympy derivation (README.md:133-135).
        """
        g_inv = self.g_inv(x4)
        # dg[mu, nu, rho] = d_rho g_{mu nu}
        dg = jax.jacfwd(self.g)(x4)
        # 1/2 (d_mu g_{nu rho} + d_nu g_{rho mu} - d_rho g_{mu nu})
        sym = 0.5 * (
            jnp.einsum("nrm->mnr", dg) + jnp.einsum("rmn->mnr", dg) - dg
        )
        return jnp.einsum("sr,mnr->smn", g_inv, sym, precision=_HI)

    def geodesic_rhs(self, x4: Array, k4: Array) -> tuple[Array, Array]:
        """(dx4/dlam, dk4/dlam) -- the 8 first-order ODEs of README.md:198-209."""
        gamma = self.christoffel(x4)
        dk = -jnp.einsum("smn,m,n->s", gamma, k4, k4, precision=_HI)
        return k4, dk

    def norm_sq(self, x4: Array, k4: Array) -> Array:
        """g_{mu nu} k^mu k^nu -- exactly 0 along a null geodesic (invariant)."""
        return jnp.einsum("mn,m,n->", self.g(x4), k4, k4, precision=_HI)

    def null_k_t(self, x4: Array, k3: Array) -> Array:
        """Future-directed k^t making (k^t, k3) null at x4.

        Solves g_tt (k^t)^2 + 2 g_ti k^t k^i + g_ij k^i k^j = 0 for the root
        with k^t > 0 (g_tt < 0 outside the horizon).
        """
        g = self.g(x4)
        a = g[0, 0]
        b = 2.0 * jnp.dot(g[0, 1:], k3, precision=_HI)
        c = jnp.dot(k3, jnp.dot(g[1:, 1:], k3, precision=_HI), precision=_HI)
        d2 = b * b - 4.0 * a * c
        # guarded sqrt keeps the jacobian finite when clamped (see
        # ops/integrate._sphere_events)
        disc = jnp.sqrt(jnp.where(d2 > 0, d2, 1.0)) * (d2 > 0)
        # a < 0 outside horizon -> the "+" root over 2a is the positive one
        return (-b - disc) / (2.0 * a)
