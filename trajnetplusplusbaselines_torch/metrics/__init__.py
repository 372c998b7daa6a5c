"""TrajNet++ metrics, copied from ``trajnetplusplusbaselines_tpu.metrics``
as far as the evaluator reaches."""

from . import batch, trajectory
from .records import Categories, Metrics, SubCategories

__all__ = ["batch", "trajectory", "Categories", "Metrics", "SubCategories"]
