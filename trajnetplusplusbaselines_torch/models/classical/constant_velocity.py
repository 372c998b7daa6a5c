"""Constant-velocity predictor: extrapolate the last observed velocity of
every track.

Port of ``trajnetplusplusbaselines_tpu/models/classical/constant_velocity.py``
on tensors.  ``predict_dataset`` extrapolates every scene of a dataset in
one device call.  The arithmetic is the JAX package's numpy, operation for
operation (a subtraction, then a product and a sum in separate kernels, no
fused multiply-add), so it is bit-exact against it in f64 on either device.
"""

from typing import List

import numpy as np
import torch

from ...data.reader import Reader
from . import device_of


def predict_xy(xy: torch.Tensor, n_predict: int = 12) -> torch.Tensor:
    """Dense CV rollout. xy [..., T, A, 2]; output [..., n_predict, A, 2]."""
    curr_position = xy[..., -1, :, :]
    curr_velocity = xy[..., -1, :, :] - xy[..., -2, :, :]
    steps = torch.arange(1, n_predict + 1, dtype=xy.dtype, device=xy.device)[:, None, None]
    return curr_position[..., None, :, :] + steps * curr_velocity[..., None, :, :]


def _output(scene: np.ndarray, predict_all: bool):
    """{0: (primary [n, 2], neighbours [n, A-1, 2])} of one scene's rollout."""
    return {0: (scene[:, 0], scene[:, 1:] if predict_all else [])}


def predict(input_paths, predict_all: bool = True, n_predict: int = 12, obs_length: int = 9,
            device="cuda"):
    """Path-level API: {mode: (primary [n,2], neighbours [n,Nn,2])}."""
    xy = torch.from_numpy(Reader.paths_to_xy(input_paths)).to(device_of(device))
    return _output(predict_xy(xy, n_predict).cpu().numpy(), predict_all)


def predict_dataset(scenes: List[list], predict_all: bool = True, n_predict: int = 12,
                    obs_length: int = 9, device="cuda") -> List[dict]:
    """``predict`` of every scene, in one device call: the last two observed
    frames of all scenes packed as [S, 2, A_max, 2], NaN-padded."""
    last = [Reader.paths_to_xy(paths)[-2:] for paths in scenes]
    packed = np.full((len(last), 2, max((x.shape[1] for x in last), default=1), 2), np.nan)
    for i, x in enumerate(last):
        packed[i, :, : x.shape[1]] = x
    out = predict_xy(torch.from_numpy(packed).to(device_of(device)), n_predict).cpu().numpy()
    return [_output(out[i, :, : x.shape[1]], predict_all) for i, x in enumerate(last)]
