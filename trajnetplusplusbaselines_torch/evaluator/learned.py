"""Batched dataset prediction for the LSTM family, the SGAN and the VAE.

Port of ``trajnetplusplusbaselines_tpu/evaluator/learned.py``: scenes are
grouped by agent bucket and rolled out in device batches, with the same
buckets and the same ``bucket_batch`` rule, so the outputs compare one to
one with the JAX package's.  Every rollout gets the slot mask
``arange(bucket) < num_agents`` and, for a goal model, the scene goals
packed beside the scenes (and centred with them under ``normalize_scene``).

The LSTM is deterministic: every mode is the same rollout.  An SGAN or a
VAE decodes its k modes as one batch of k * S scenes after one encoder run
(``models/sgan.py``), where the JAX package vmaps (SGAN) or loops (VAE) over
the modes; each rollout chunk advances the seed by one, as the JAX package
does, and draws its noise (SGAN, [k, noise_dim]) or its latent normals
(VAE, [k, S, A, latent]) from a ``torch.Generator`` seeded with it
(``draws``).  Mode 0 keeps the neighbours, later modes the primary only.
"""

from collections import defaultdict
from typing import List, Tuple

import numpy as np
import torch

from ..data import Reader, augmentation, batching
from ..models.lstm import to_numpy
from ..models.sgan import SGAN
from ..models.vae import VAE
from ..utils.convert import params_to


class BatchedPredictor:
    """Wraps an ``LSTMPredictor``, ``SGANPredictor`` or ``VAEPredictor`` for
    whole-dataset batched rollout on ``device``.  ``goal_flag`` tells the
    driver to load the test goal files."""

    def __init__(self, predictor, modes: int = 1, batch_scenes: int = 64, device="cuda",
                 seed: int = 0):
        self.predictor = predictor
        self.modes = modes
        self.batch_scenes = batch_scenes
        self.device = torch.device(device)
        self.seed = seed
        self.goal_flag = bool(predictor.model.goal_flag)
        self._device_params = None

    def draws(self, num_scenes: int, num_agents: int):
        """The random draws of one rollout chunk of ``num_scenes`` x
        ``num_agents``, from a ``torch.Generator`` seeded with ``seed``: an
        SGAN's noise [modes, noise_dim] (None under ``no_noise``), a VAE's
        latent normals [modes, S, A, latent], None for the LSTM."""
        model = self.predictor.model
        rng = torch.Generator().manual_seed(self.seed)
        if isinstance(model, SGAN):
            generator = model.generator
            return None if generator.no_noise else generator.draw_noise(self.modes, rng)
        if isinstance(model, VAE):
            return model.draw_eps(self.modes, num_scenes, num_agents, rng)
        return None

    def rollout(self, xy, mask, goals, slot_mask, n_predict: int):
        """(pred [K, T', S, A, 2], valid [K, T', S, A]) of one chunk: K is the
        number of modes of an SGAN or a VAE, 1 for the LSTM."""
        model, params = self.predictor.model, self._device_params
        kw = dict(n_predict=n_predict, goals=goals, slot_mask=slot_mask)
        with torch.no_grad():
            if isinstance(model, SGAN):
                _, pred, valid = model.generate(params, xy, mask, modes=self.modes,
                                                noise=self.draws(*xy.shape[1:3]), **kw)
            elif isinstance(model, VAE):
                _, pred, valid, _, _ = model.forward(params, xy, mask, training=False,
                                                     modes=self.modes,
                                                     eps=self.draws(*xy.shape[1:3]), **kw)
            else:
                _, pred, valid = model.forward(params, xy, mask, **kw)
                pred, valid = pred[None], valid[None]
        return pred, valid

    def predict_dataset(self, processed_scenes: List[list], scene_goals, args):
        """processed_scenes: per-scene path lists already preprocess_test-ed;
        scene_goals: per-scene goals [n, 2], read only by a goal model.

        Returns a list of {mode: [primary [n,2], neighbours [n,Nn,2] or []]}.
        """
        n_predict = args.pred_length
        obs_length = args.obs_length
        normalize = getattr(args, "normalize_scene", False)
        if self._device_params is None:
            # in the model's compute dtype (a bf16 model serves in bf16)
            self._device_params = params_to(self.predictor.params, self.device,
                                            getattr(self.predictor.model, "compute_dtype", None))

        prepared = []
        for paths, goal in zip(processed_scenes, scene_goals):
            xy = Reader.paths_to_xy(paths)
            goal = np.asarray(goal, dtype=np.float64) if self.goal_flag else None
            rotation = center = None
            if normalize:
                xy, rotation, center, *centred = augmentation.center_scene(xy, obs_length,
                                                                           goals=goal)
                goal = centred[0] if self.goal_flag else None
            prepared.append((xy[:obs_length], goal, rotation, center, xy.shape[1]))

        results = [None] * len(prepared)
        plan = bucket_plan([xy.shape[1] for xy, *_rest in prepared], self.batch_scenes)
        for bucket, bucket_batch, chunk in plan:
            goals = None
            if self.goal_flag:
                goals = []
                for i in chunk:
                    g = np.zeros((bucket, 2), dtype=np.float64)
                    real = prepared[i][1][:bucket]
                    g[: len(real)] = real
                    goals.append(g)
            packed = batching.pack_scenes([prepared[i][0] for i in chunk], goals,
                                          bucket=bucket, pad_scenes_to=bucket_batch)
            slot = np.arange(bucket)[None] < packed.num_agents[:, None]
            self.seed += 1
            pred, valid = self.rollout(
                *(torch.from_numpy(x).to(self.device)
                  for x in (packed.xy, packed.mask, packed.goals, slot)), n_predict)
            out = batching.mask_to_nan(to_numpy(pred), valid.cpu().numpy())  # [K, T', S, A, 2]

            for s, i in enumerate(chunk):
                _, _, rotation, center, n_agents = prepared[i]
                scene_out = out[:, -n_predict:, s, :n_agents]
                if normalize:
                    scene_out = augmentation.inverse_scene(scene_out, rotation, center)
                results[i] = {0: [scene_out[0][:, 0], scene_out[0][:, 1:]]}
                for mode in range(1, self.modes):
                    results[i][mode] = [scene_out[min(mode, len(out) - 1)][:, 0], []]
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
