from .bridge import seismic_model_from_numpy
from .model import (
    SeismicModel,
    Shot,
    make_demo_model,
    make_shot_grid,
    resolve_device,
    ricker,
    run_shot,
)

__all__ = [
    "SeismicModel",
    "Shot",
    "make_demo_model",
    "make_shot_grid",
    "resolve_device",
    "ricker",
    "run_shot",
    "seismic_model_from_numpy",
]
