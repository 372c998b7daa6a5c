"""ndjson serialization of rows.

Copy of ``trajnetplusplusbaselines_tpu/data/writers.py``.
"""

import json

from .rows import SceneRow, TrackRow


def trajnet(row) -> str:
    if isinstance(row, TrackRow):
        track = {
            "f": row.frame,
            "p": row.pedestrian,
            "x": round(row.x, 2),
            "y": round(row.y, 2),
        }
        if row.prediction_number is not None:
            track["prediction_number"] = row.prediction_number
        if row.scene_id is not None:
            track["scene_id"] = row.scene_id
        return json.dumps({"track": track})

    if isinstance(row, SceneRow):
        return json.dumps(
            {
                "scene": {
                    "id": row.scene,
                    "p": row.pedestrian,
                    "s": row.start,
                    "e": row.end,
                    "fps": row.fps,
                    "tag": row.tag,
                }
            }
        )

    raise Exception("unknown row type")
