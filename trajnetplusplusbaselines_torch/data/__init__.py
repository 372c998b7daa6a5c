"""Scene data of the TrajNet++ format: rows, the ndjson reader and writer,
scene normalization, packing and dataset enumeration.

Copied from ``trajnetplusplusbaselines_tpu.data`` (numpy only), as far as
the port's callers reach, so that the port imports nothing of the JAX
package.
"""

from . import augmentation, batching, interactions, writers
from .load import prepare_data
from .reader import Reader
from .rows import SceneRow, TrackRow

__all__ = ["SceneRow", "TrackRow", "Reader", "writers", "augmentation", "batching",
           "interactions", "prepare_data"]
