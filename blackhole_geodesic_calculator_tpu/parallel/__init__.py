"""Distributed/parallel layer: device meshes, sharded rendering, training.

The reference has no distributed runtime (SURVEY.md §2.2); this package is
the replacement: jax.sharding meshes, ray-sharded SPMD rendering
with load-balancing shuffle, sample-axis parallel multisampling, and
gradient-all-reduced training steps.
"""

from .mesh import make_mesh, ray_sharding, replicated, RAY_AXIS, SAMPLE_AXIS
from .render import (polarization_map_sharded, render_image_sharded,
                     render_stokes_sharded)
from .train import Trainer, default_loss
from .multihost import (
    init_distributed, global_mesh, gather_image, render_shards_with_retry,
    render_with_failover,
)

__all__ = [
    "make_mesh", "ray_sharding", "replicated", "RAY_AXIS", "SAMPLE_AXIS",
    "render_image_sharded", "polarization_map_sharded",
    "render_stokes_sharded",
    "Trainer", "default_loss",
    "init_distributed", "global_mesh", "gather_image",
    "render_shards_with_retry", "render_with_failover",
]
