"""Row types of the TrajNet++ ndjson format.

Copy of ``trajnetplusplusbaselines_tpu/data/rows.py``, so that the port
imports nothing of the JAX package.  A *track row* is one observation of one
pedestrian at one frame.  A *scene row* declares a scene: a primary
pedestrian and a [start, end] frame window, with a categorisation tag (type
1 static / 2 linear / 3 forced-non-linear / 4 non-linear; subtypes 1
leader-follower / 2 collision-avoidance / 3 group / 4 others).
"""

from typing import NamedTuple, Optional, Union


class TrackRow(NamedTuple):
    frame: int
    pedestrian: int
    x: float
    y: float
    prediction_number: Optional[int] = None
    scene_id: Optional[int] = None


class SceneRow(NamedTuple):
    scene: int
    pedestrian: int
    start: int
    end: int
    fps: float = 2.5
    tag: Union[int, list, None] = None
