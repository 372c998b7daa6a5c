"""Scene packing: ragged scenes -> dense padded [T, S, A, 2] arrays + masks.

Copy of ``trajnetplusplusbaselines_tpu/data/batching.py``.  Scenes are an
array axis: a batch is a dense ``[time, scene, agent, 2]`` array with a
boolean presence mask, the agent axis padded to a small set of buckets.
"""

import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DEFAULT_AGENT_BUCKETS = (4, 8, 16, 32, 64, 128)


class PackedScenes(NamedTuple):
    """A dense batch of scenes.

    xy:         [T, S, A, 2] float32, zeros where absent
    mask:       [T, S, A]    bool, True where the agent is observed
    goals:      [S, A, 2]    float32
    num_agents: [S]          int32, real agents per scene (primary = agent 0)
    """

    xy: np.ndarray
    mask: np.ndarray
    goals: np.ndarray
    num_agents: np.ndarray

    @property
    def seq_length(self) -> int:
        return self.xy.shape[0]

    @property
    def num_scenes(self) -> int:
        return self.xy.shape[1]

    @property
    def max_agents(self) -> int:
        return self.xy.shape[2]


def agent_bucket(n: int, buckets: Sequence[int] = DEFAULT_AGENT_BUCKETS) -> int:
    """Smallest bucket >= n, or the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def nan_to_mask(xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a NaN-padded array into (zeros-filled values, presence mask)."""
    mask = ~np.isnan(xy).any(axis=-1)
    return np.where(mask[..., None], xy, 0.0), mask


def mask_to_nan(xy: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Inverse of nan_to_mask for the I/O edge."""
    return np.where(mask[..., None], xy, np.nan)


def pack_scenes(
    scenes_xy: List[np.ndarray],
    goals: Optional[List[np.ndarray]] = None,
    bucket: Optional[int] = None,
    pad_scenes_to: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_AGENT_BUCKETS,
) -> PackedScenes:
    """Pack a list of NaN-padded ``[T, A_i, 2]`` scenes into one dense batch.

    With ``bucket=None`` the agent axis grows to fit the largest scene (a
    dynamic bucket beyond ``buckets[-1]`` when needed) so no agent is ever
    silently dropped; an explicit ``bucket`` truncates with a warning
    (truncation loses neighbour predictions, which flips the evaluator's
    Col-I sentinel to -1 for the whole run).  Scenes beyond ``pad_scenes_to``
    raise.  Padding scenes are fully masked so they contribute nothing to
    losses or metrics.
    """
    if not scenes_xy:
        raise ValueError("pack_scenes needs at least one scene")

    seq_length = scenes_xy[0].shape[0]
    for s in scenes_xy:
        if s.shape[0] != seq_length:
            raise ValueError(
                f"all scenes in a batch must share seq_length; got {s.shape[0]} != {seq_length}"
            )

    max_real = max(s.shape[1] for s in scenes_xy)
    if bucket is not None:
        a = bucket
        if max_real > a:
            warnings.warn(
                f"pack_scenes: truncating scenes with up to {max_real} agents "
                f"to bucket {a}; neighbour predictions will be lost",
                stacklevel=2,
            )
    else:
        a = max(agent_bucket(max_real, buckets), max_real)
    n_scenes = len(scenes_xy)
    s_pad = pad_scenes_to if pad_scenes_to is not None else n_scenes
    if s_pad < n_scenes:
        raise ValueError("pad_scenes_to smaller than the number of scenes")

    xy = np.zeros((seq_length, s_pad, a, 2), dtype=np.float32)
    mask = np.zeros((seq_length, s_pad, a), dtype=bool)
    goal_arr = np.zeros((s_pad, a, 2), dtype=np.float32)
    num_agents = np.zeros((s_pad,), dtype=np.int32)

    for i, scene in enumerate(scenes_xy):
        n = min(scene.shape[1], a)
        vals, m = nan_to_mask(scene[:, :n])
        xy[:, i, :n] = vals.astype(np.float32)
        mask[:, i, :n] = m
        num_agents[i] = n
        if goals is not None and goals[i] is not None:
            g = np.asarray(goals[i], dtype=np.float32)
            goal_arr[i, :n] = g[:n]

    return PackedScenes(xy=xy, mask=mask, goals=goal_arr, num_agents=num_agents)


def unpack_scene(packed: PackedScenes, i: int) -> np.ndarray:
    """Recover scene i as a NaN-padded ``[T, num_agents_i, 2]`` array."""
    n = int(packed.num_agents[i])
    return mask_to_nan(packed.xy[:, i, :n], packed.mask[:, i, :n])


def batch_iterator(
    scenes_xy: List[np.ndarray],
    goals: Optional[List[np.ndarray]],
    batch_size: int,
    buckets: Sequence[int] = DEFAULT_AGENT_BUCKETS,
):
    """Yield PackedScenes batches of at most batch_size scenes.

    The final short batch is padded (fully masked) up to batch_size, so every
    batch has the same scene axis.
    """
    for start in range(0, len(scenes_xy), batch_size):
        chunk = scenes_xy[start : start + batch_size]
        chunk_goals = goals[start : start + batch_size] if goals is not None else None
        yield pack_scenes(chunk, chunk_goals, pad_scenes_to=batch_size, buckets=buckets)
