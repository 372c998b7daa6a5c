"""ndjson scene reader.

Copy of ``trajnetplusplusbaselines_tpu/data/reader.py``.  One JSON object
per line, either ``{"scene": {"id", "p", "s", "e", "fps", "tag"}}`` or
``{"track": {"f", "p", "x", "y"[, "prediction_number", "scene_id"]}}``.
"""

import itertools
import json
import random
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .rows import SceneRow, TrackRow


class Reader:
    """Read a TrajNet++ ndjson file and iterate over its scenes.

    scene_type:
        'rows'  -> scenes yield the raw TrackRows
        'paths' -> scenes yield a list of per-pedestrian paths, primary first
        'tags'  -> scenes yield (tag, paths)
    """

    def __init__(self, input_file: str, scene_type: Optional[str] = None):
        if scene_type is not None and scene_type not in ("rows", "paths", "tags"):
            raise Exception("scene_type not supported")
        self.scene_type = scene_type or "rows"

        self.tracks_by_frame: Dict[int, List[TrackRow]] = defaultdict(list)
        self.scenes_by_id: Dict[int, SceneRow] = {}

        self.read_file(input_file)

    def read_file(self, input_file: str) -> None:
        with open(input_file, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)

                track = obj.get("track")
                if track is not None:
                    row = TrackRow(
                        track["f"],
                        track["p"],
                        track["x"],
                        track["y"],
                        track.get("prediction_number"),
                        track.get("scene_id"),
                    )
                    self.tracks_by_frame[row.frame].append(row)
                    continue

                scene = obj.get("scene")
                if scene is not None:
                    row = SceneRow(
                        scene["id"],
                        scene["p"],
                        scene["s"],
                        scene["e"],
                        scene.get("fps", 2.5),
                        scene.get("tag"),
                    )
                    self.scenes_by_id[row.scene] = row

    def scenes(
        self,
        randomize: bool = False,
        limit: int = 0,
        ids: Optional[List[int]] = None,
        sample: Optional[float] = None,
    ) -> Iterator[Tuple[int, list]]:
        scene_ids = list(self.scenes_by_id.keys())
        if ids is not None:
            scene_ids = ids
        if randomize:
            scene_ids = list(scene_ids)
            random.shuffle(scene_ids)
        if limit:
            scene_ids = list(itertools.islice(scene_ids, limit))
        if sample is not None and sample < 1.0:
            scene_ids = random.sample(scene_ids, int(len(scene_ids) * sample))
        for scene_id in scene_ids:
            yield self.scene(scene_id)

    def paths(self, scene_row: SceneRow) -> list:
        """All pedestrian paths within the scene window; primary path first."""
        by_pedestrian: Dict[int, List[TrackRow]] = defaultdict(list)
        for frame in range(scene_row.start, scene_row.end + 1):
            for row in self.tracks_by_frame.get(frame, []):
                by_pedestrian[row.pedestrian].append(row)

        primary = by_pedestrian.pop(scene_row.pedestrian, [])
        return [primary] + list(by_pedestrian.values())

    def scene(self, scene_id: int) -> Tuple[int, list]:
        scene_row = self.scenes_by_id.get(scene_id)
        if scene_row is None:
            raise Exception("scene with that id not found")

        if self.scene_type == "rows":
            rows = [
                row
                for frame in range(scene_row.start, scene_row.end + 1)
                for row in self.tracks_by_frame.get(frame, [])
            ]
            return scene_id, rows

        paths = self.paths(scene_row)
        if self.scene_type == "tags":
            return scene_id, (scene_row.tag, paths)
        return scene_id, paths

    @staticmethod
    def paths_to_xy(paths: list) -> np.ndarray:
        """Convert paths to a ``[T, num_tracks, 2]`` array, NaN where absent.

        The time axis is indexed by the primary pedestrian's frames; rows of
        other pedestrians at frames the primary does not visit are dropped.
        """
        frames = [r.frame for r in paths[0]]
        frame_to_index = {frame: t for t, frame in enumerate(frames)}

        xy = np.full((len(frames), len(paths), 2), np.nan)
        for ped_index, path in enumerate(paths):
            for row in path:
                t = frame_to_index.get(row.frame)
                if t is None:
                    continue
                xy[t, ped_index, 0] = row.x
                xy[t, ped_index, 1] = row.y
        return xy
