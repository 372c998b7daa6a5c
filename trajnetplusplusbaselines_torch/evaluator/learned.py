"""Batched dataset prediction for the LSTM.

Port of the LSTM branch of ``trajnetplusplusbaselines_tpu/evaluator/
learned.py``: scenes are grouped by agent bucket and rolled out in device
batches, with the same buckets and the same ``bucket_batch`` rule, so the
outputs compare one to one with the JAX package's.
"""

from collections import defaultdict
from typing import List, Tuple

import torch

from trajnetplusplusbaselines_tpu.data import Reader, augmentation, batching

from ..utils.convert import params_to


class BatchedPredictor:
    """Wraps an ``LSTMPredictor`` for whole-dataset batched rollout on
    ``device``.  The model is deterministic: every mode is the same
    rollout, and modes after the first keep the primary only."""

    def __init__(self, predictor, modes: int = 1, batch_scenes: int = 64, device="cuda"):
        self.predictor = predictor
        self.modes = modes
        self.batch_scenes = batch_scenes
        self.device = torch.device(device)
        self._device_params = None

    def predict_dataset(self, processed_scenes: List[list], scene_goals, args):
        """processed_scenes: per-scene path lists already preprocess_test-ed.

        Returns a list of {mode: [primary [n,2], neighbours [n,Nn,2]]}.
        """
        n_predict = args.pred_length
        obs_length = args.obs_length
        normalize = getattr(args, "normalize_scene", False)
        if self._device_params is None:
            self._device_params = params_to(self.predictor.params, self.device)

        prepared = []
        for paths in processed_scenes:
            xy = Reader.paths_to_xy(paths)
            rotation = center = None
            if normalize:
                xy, rotation, center = augmentation.center_scene(xy, obs_length)
            prepared.append((xy[:obs_length], rotation, center, xy.shape[1]))

        results = [None] * len(prepared)
        plan = bucket_plan([xy.shape[1] for xy, *_rest in prepared], self.batch_scenes)
        for bucket, bucket_batch, chunk in plan:
            packed = batching.pack_scenes(
                [prepared[i][0] for i in chunk], bucket=bucket, pad_scenes_to=bucket_batch
            )
            _, pred, valid = self.predictor.model.forward(
                self._device_params,
                torch.from_numpy(packed.xy).to(self.device),
                torch.from_numpy(packed.mask).to(self.device),
                n_predict=n_predict,
            )
            out = batching.mask_to_nan(pred.cpu().numpy(), valid.cpu().numpy())

            for s, i in enumerate(chunk):
                _, rotation, center, n_agents = prepared[i]
                scene_out = out[-n_predict:, s, :n_agents]
                if normalize:
                    scene_out = augmentation.inverse_scene(scene_out, rotation, center)
                results[i] = {0: [scene_out[:, 0], scene_out[:, 1:]]}
                for mode in range(1, self.modes):
                    results[i][mode] = [scene_out[:, 0], []]
        return results


def bucket_plan(agent_counts: List[int], batch_scenes: int) -> List[Tuple[int, int, List[int]]]:
    """The rollouts ``predict_dataset`` makes, in order: (agent bucket,
    scenes per rollout, indices of the scenes it holds) for scenes of
    ``agent_counts`` agents.

    Scenes are grouped by agent bucket; a scene larger than the largest
    bucket gets a bucket of its own agent count, so every neighbour is
    predicted.  A rollout holds ``batch_scenes * 8 // max(bucket, 8)``
    scenes, padded to that many."""
    by_bucket = defaultdict(list)
    for i, n in enumerate(agent_counts):
        by_bucket[max(batching.agent_bucket(n), n)].append(i)
    plan = []
    for bucket, indices in sorted(by_bucket.items()):
        bucket_batch = max(1, (batch_scenes * 8) // max(bucket, 8))
        for start in range(0, len(indices), bucket_batch):
            plan.append((bucket, bucket_batch, indices[start : start + bucket_batch]))
    return plan
