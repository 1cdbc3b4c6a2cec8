"""Flat (Minkowski) metric -- the validation backend.

Mirrors the reference's ``metric='flat'`` option used "to compare curved and
non curved scenarios precisely" (reference README.md:233, selected through the
scene property at /root/reference/raytracer/LimitedRelativisticRenderEngine.py:90,487).
Geodesics through this metric must be exactly straight lines; the test suite
enforces that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .metric import Metric

# numpy constant: importing the package must not initialize a backend
ETA = np.diag(np.asarray([-1.0, 1.0, 1.0, 1.0], np.float32))


def _g_flat(x4):
    del x4
    return jnp.asarray(ETA)


def flat_metric() -> Metric:
    return Metric(g_fn=_g_flat, params=(), name="flat")
