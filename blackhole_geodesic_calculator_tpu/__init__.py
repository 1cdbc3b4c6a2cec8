"""blackhole_geodesic_calculator_tpu -- a differentiable general-relativistic
ray tracer for GPUs.

A JAX/XLA/Pallas framework with the capabilities of the reference
Blender render engines in bldevries/blackhole_geodesic_calculator (see
SURVEY.md): every camera ray is a null-geodesic ODE solve through
Schwarzschild/Kerr spacetime, batched over the whole image, jitted, sharded
and differentiable end to end.
"""

from . import models, ops, scene, camera, render, parallel, utils

__version__ = "0.3.0"
