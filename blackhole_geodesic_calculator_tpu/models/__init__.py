"""Spacetime metric families (the framework's "model zoo").

flat          -- Minkowski validation metric (reference metric='flat').
schwarzschild -- reference default spacetime, two Cartesian charts.
kerr          -- spinning hole, Kerr-Schild form (reference Gen-3 `a` param).
surrogate     -- learned (MLP, f32/bf16) scattering-map fast path, the
                 reference's planned 'Tensorflow model' milestone
                 (README.md:237), trained on the device against the
                 integrator.
"""

from .metric import Metric
from .flat import flat_metric, ETA
from .schwarzschild import (
    schwarzschild_cartesian_metric,
    schwarzschild_ks_metric,
)
from .kerr import kerr_ks_metric, ks_radius, ks_scalars, horizon_radius
from .surrogate import (
    SurrogateConfig,
    NeuralSurrogate,
    train_surrogate,
    evaluate_surrogate,
    save_surrogate,
    load_surrogate,
)

__all__ = [
    "SurrogateConfig",
    "NeuralSurrogate",
    "train_surrogate",
    "evaluate_surrogate",
    "save_surrogate",
    "load_surrogate",
    "Metric",
    "flat_metric",
    "ETA",
    "schwarzschild_cartesian_metric",
    "schwarzschild_ks_metric",
    "kerr_ks_metric",
    "ks_radius",
    "ks_scalars",
    "horizon_radius",
]
