"""LSTM trajectory forecaster: the autoregressive rollout, step by step.

Port of ``trajnetplusplusbaselines_tpu/models/lstm.py`` for serving
(``init_params``, ``init_carry``, ``step``, ``encode``, autoregressive
``decode``, ``forward(n_predict=...)`` and ``LSTMPredictor.__call__``).
Teacher forcing and training are not ported yet.

Shapes: observed [T, S, A, 2]; masks [T, S, A] bool; outputs (rel_pred
[T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]) with T' = (T_obs - 1) +
(n_predict - 1), of which the trailing ``n_predict`` entries are the
prediction window.  A rollout of 9 observed and 12 predicted frames is 19
serial steps: 8 encoder transitions and 11 decoder steps.

The step of a goal-free directional ``one_layer`` grid model (the D-LSTM) is
the fused step of ``ops/cuda/fused_step.py``: one kernel launch on the card,
its plain version on the CPU.  Other configurations (vanilla, occupancy) run
the same plain step (``lstm_step_plain``) around their own pool on either
device.  The encoder pools per step:
the JAX package's observation-phase fold is an exact regrouping of the same
per-step values (``tests/test_static_pool.py``) made for the TPU.
"""

from typing import Dict, List, NamedTuple, Optional

import torch

from ..ops.core import init_lstm_cell
from ..ops.cuda.fused_step import (
    check_weights,
    fused_dlstm_step,
    lstm_step_plain,
    weights_from_params,
)
from ..ops.embeddings import init_hidden2normal, init_input_embedding


class StepCarry(NamedTuple):
    h: torch.Tensor  # [S, A, H]
    c: torch.Tensor  # [S, A, H]


class LSTM:
    """Static model configuration; parameters live in a dict."""

    def __init__(
        self,
        embedding_dim: int = 64,
        hidden_dim: int = 128,
        pool=None,
        pool_to_input: bool = True,
        goal_dim: Optional[int] = None,
        goal_flag: bool = False,
    ):
        if goal_flag:
            raise NotImplementedError("goal-conditioned LSTM is not ported yet")
        if pool is not None and not pool_to_input:
            raise NotImplementedError("pool_to_input=False is not ported yet")
        self.embedding_dim = embedding_dim
        self.hidden_dim = hidden_dim
        self.pool = pool
        self.pool_to_input = pool_to_input
        self.goal_flag = goal_flag
        self.goal_dim = goal_dim or embedding_dim
        pooling_dim = pool.out_dim if pool is not None else 0
        self.input_dim = embedding_dim + pooling_dim

    @property
    def fused(self) -> bool:
        """True when a step is one fused D-LSTM step."""
        return self.pool is not None and self.pool.type_ == "directional"

    # ---------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params = {
            "input_embedding": init_input_embedding(generator, 2, self.embedding_dim, **kw),
            "goal_embedding": init_input_embedding(generator, 2, self.goal_dim, **kw),
            "encoder": init_lstm_cell(generator, self.input_dim, self.hidden_dim, **kw),
            "decoder": init_lstm_cell(generator, self.input_dim, self.hidden_dim, **kw),
            "hidden2normal": init_hidden2normal(generator, self.hidden_dim, **kw),
        }
        if self.pool is not None:
            params["pool"] = self.pool.init_params(generator, **kw)
        return params

    def init_carry(self, num_scenes: int, num_agents: int, device=None,
                   dtype=torch.float32) -> StepCarry:
        shape = (num_scenes, num_agents, self.hidden_dim)
        return StepCarry(torch.zeros(shape, device=device, dtype=dtype),
                         torch.zeros(shape, device=device, dtype=dtype))

    # ------------------------------------------------------------------ step
    def step(self, params: Dict, cell_name: str, carry: StepCarry, obs1, obs2,
             present1, present2, weights: Optional[Dict] = None):
        """One recurrence step. Returns (carry, normal [S,A,5], mask [S,A]).

        weights: ``weights_from_params(params, cell_name)``, made once per
        rollout by ``forward``; None makes them here."""
        if weights is None:
            weights = weights_from_params(params, cell_name)
        pool = self.pool
        if self.fused:
            h, c, normal, mask = fused_dlstm_step(
                obs1, obs2, present1, present2, carry.h, carry.c, weights,
                n=pool.n, cell_side=pool.cell_side, constant=pool.constant,
            )
        else:
            pooled = (pool.apply(params["pool"], obs1, obs2, present1, present2)
                      if pool is not None else None)
            h, c, normal, mask = lstm_step_plain(weights, obs1, obs2, present1, present2,
                                                 carry.h, carry.c, pooled)
        return StepCarry(h, c), normal, mask

    # --------------------------------------------------------------- encoder
    def encode(self, params, carry, observed, observed_mask, weights=None):
        """Run the encoder over the observation transitions.

        Returns (carry, normals, masks, positions), each a list of T-1
        per-step tensors."""
        normals: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        positions: List[torch.Tensor] = []
        for t in range(observed.shape[0] - 1):
            carry, normal, mask = self.step(
                params, "encoder", carry, observed[t], observed[t + 1],
                observed_mask[t], observed_mask[t + 1], weights,
            )
            normals.append(normal)
            masks.append(mask)
            positions.append((observed[t + 1] + normal[..., :2]) * mask[..., None])
        return carry, normals, masks, positions

    # --------------------------------------------------------------- decoder
    def decode(self, params, carry, pos_a, valid_a, pos_b, valid_b, n_steps: int,
               weights=None):
        """Autoregress the decoder for n_steps from the last two positions.

        Returns (carry, normals, masks, positions), each a list of n_steps
        per-step tensors."""
        normals, masks, positions = [], [], []
        for _ in range(n_steps):
            carry, normal, mask = self.step(
                params, "decoder", carry, pos_a, pos_b, valid_a, valid_b, weights
            )
            new_pos = (pos_b + normal[..., :2]) * mask[..., None]
            normals.append(normal)
            masks.append(mask)
            positions.append(new_pos)
            pos_a, valid_a, pos_b, valid_b = pos_b, valid_b, new_pos, mask
        return carry, normals, masks, positions

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None):
        """Full autoregressive rollout on the device and dtype of ``params``.

        Returns (rel_pred [T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]).
        """
        if prediction_truth is not None or prediction_truth_mask is not None:
            raise NotImplementedError("teacher forcing is not ported yet")
        if n_predict is None or n_predict < 1:
            raise ValueError("forward needs n_predict >= 1")
        ref = params["encoder"]["w_ih"]
        observed = torch.as_tensor(observed).to(device=ref.device, dtype=ref.dtype).contiguous()
        observed_mask = torch.as_tensor(observed_mask).to(device=ref.device,
                                                          dtype=torch.bool).contiguous()
        s, a = observed.shape[1], observed.shape[2]
        carry = self.init_carry(s, a, device=ref.device, dtype=ref.dtype)
        weights = {cell: weights_from_params(params, cell) for cell in ("encoder", "decoder")}
        if self.fused and ref.device.type == "cuda":
            # checked against the kernel once here, not at each of its launches
            weights = {cell: check_weights(w, ref.device) for cell, w in weights.items()}

        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, carry, observed, observed_mask, weights["encoder"]
        )

        # the decoder starts from the last observed frame for every
        # neighbour; only the primary reads the model's own positions[-2]
        # (with a 2-frame observation the observation stands in for it)
        if observed.shape[0] == 2:
            prim_a, prim_valid_a = observed[-1][:, 0], observed_mask[-1][:, 0]
        else:
            prim_a, prim_valid_a = enc_positions[-2][:, 0], enc_masks[-2][:, 0]
        pos_a = observed[-1].clone()
        pos_a[:, 0] = prim_a
        valid_a = observed_mask[-1].clone()
        valid_a[:, 0] = prim_valid_a

        carry, dec_normals, dec_masks, dec_positions = self.decode(
            params, carry, pos_a, valid_a, enc_positions[-1], enc_masks[-1],
            n_predict - 1, weights["decoder"],
        )
        rel_pred = torch.stack(enc_normals + dec_normals)
        pred = torch.stack(enc_positions + dec_positions)
        valid = torch.stack(enc_masks + dec_masks)
        return rel_pred, pred, valid


class LSTMPredictor:
    """Path-level prediction API: paths in, ``{mode: [primary [n, 2],
    neighbours [n, Nn, 2]]}`` out.  The rollout runs on the device of
    ``params``; the model is deterministic, so every mode is the same."""

    def __init__(self, model: LSTM, params: Dict):
        self.model = model
        self.params = params

    def __call__(
        self,
        paths,
        scene_goal,
        n_predict: int = 12,
        modes: int = 1,
        predict_all: bool = True,
        obs_length: int = 9,
        start_length: int = 0,
        args=None,
    ):
        from trajnetplusplusbaselines_tpu.data import Reader, augmentation, batching

        xy = Reader.paths_to_xy(paths)
        normalize = bool(getattr(args, "normalize_scene", False)) if args is not None else False
        if normalize:
            xy, rotation, center = augmentation.center_scene(xy, obs_length)

        packed = batching.pack_scenes([xy[start_length:obs_length]])
        _, pred, valid = self.model.forward(
            self.params, torch.from_numpy(packed.xy), torch.from_numpy(packed.mask),
            n_predict=n_predict,
        )
        output = batching.mask_to_nan(pred.cpu().numpy(), valid.cpu().numpy())
        output = output[:, 0, : xy.shape[1]]  # [T', A, 2]
        if normalize:
            output = augmentation.inverse_scene(output, rotation, center)
        return {mode: [output[-n_predict:, 0], output[-n_predict:, 1:]]
                for mode in range(modes)}
