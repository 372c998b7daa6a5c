"""TrajNet++ metrics, copied from ``trajnetplusplusbaselines_tpu.metrics``
as far as the evaluator reaches."""

from . import trajectory
from .records import Categories, Metrics, SubCategories

__all__ = ["trajectory", "Categories", "Metrics", "SubCategories"]
