"""Scene data of the TrajNet++ format: rows, the ndjson reader and writer,
scene normalization, packing and dataset enumeration.

Copied from ``trajnetplusplusbaselines_tpu.data`` (numpy only), with the
same exports, so that the port imports nothing of the JAX package.
"""

from . import augmentation, batching, interactions, writers
from .augmentation import (
    add_noise,
    center_scene,
    drop_distant,
    drop_unobserved,
    inverse_scene,
    random_rotation,
    theta_rotation,
)
from .batching import (
    DEFAULT_AGENT_BUCKETS,
    PackedScenes,
    agent_bucket,
    batch_iterator,
    mask_to_nan,
    nan_to_mask,
    pack_scenes,
    unpack_scene,
)
from .load import prepare_data
from .reader import Reader
from .rows import SceneRow, TrackRow

__all__ = [
    "SceneRow",
    "TrackRow",
    "Reader",
    "writers",
    "augmentation",
    "batching",
    "interactions",
    "add_noise",
    "center_scene",
    "drop_distant",
    "drop_unobserved",
    "inverse_scene",
    "random_rotation",
    "theta_rotation",
    "DEFAULT_AGENT_BUCKETS",
    "PackedScenes",
    "agent_bucket",
    "batch_iterator",
    "mask_to_nan",
    "nan_to_mask",
    "pack_scenes",
    "unpack_scene",
    "prepare_data",
]
