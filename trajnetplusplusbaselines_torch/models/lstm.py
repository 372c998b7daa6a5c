"""LSTM trajectory forecaster: the autoregressive rollout, step by step.

Port of ``trajnetplusplusbaselines_tpu/models/lstm.py`` (``init_params``,
``init_carry``, ``step``, ``encode``, ``decode`` autoregressive or teacher
forced, ``forward`` and ``LSTMPredictor.__call__``).

Shapes: observed [T, S, A, 2]; masks [T, S, A] bool; outputs (rel_pred
[T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]) with T' = (T_obs - 1) +
(n_predict - 1), of which the trailing ``n_predict`` entries are the
prediction window.  A rollout of 9 observed and 12 predicted frames is 19
serial steps: 8 encoder transitions and 11 decoder steps.

The step of a goal-free directional ``one_layer`` grid model (the D-LSTM) is
the fused step of ``ops/cuda/fused_step.py`` (one kernel launch on the card,
its plain version on the CPU) where autograd does not record it.  Where it
does (training), the step is ``grid_dlstm_step``: the kernel's grid stage,
which needs no gradient, then the grid embedding and ``lstm_step_plain``
under autograd.  Other configurations (vanilla, occupancy) run the same plain
step (``lstm_step_plain``) around their own pool on either device.  Whether
autograd records is the caller's choice: serving and validation call
``forward`` under ``torch.no_grad()``.  The encoder pools per step:
the JAX package's observation-phase fold is an exact regrouping of the same
per-step values (``tests/test_static_pool.py``) made for the TPU.
"""

from typing import Dict, List, NamedTuple, Optional

import torch

from ..ops.core import init_lstm_cell
from ..ops.cuda.fused_step import (
    autograd_records,
    check_weights,
    fused_dlstm_step,
    grid_dlstm_step,
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
            step = (grid_dlstm_step if autograd_records(carry.h, carry.c, *weights.values())
                    else fused_dlstm_step)
            h, c, normal, mask = step(
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
               weights=None, truth=None, truth_mask=None):
        """Run the decoder for n_steps from the last two positions.

        truth / truth_mask: [n_steps + 1, S, A, ...] ground-truth chain
        starting at the last observed frame (teacher forcing); None for full
        autoregression.  The primary (agent 0) always reads the model's own
        detached position, and in autoregression every agent does.

        Returns (carry, normals, masks, positions), each a list of n_steps
        per-step tensors."""
        normals, masks, positions = [], [], []
        for k in range(n_steps):
            if truth is not None:
                obs1, p1 = _set_primary(truth[k], truth_mask[k], pos_a, valid_a)
                obs2, p2 = _set_primary(truth[k + 1], truth_mask[k + 1], pos_b, valid_b)
            else:
                obs1, p1, obs2, p2 = pos_a.detach(), valid_a, pos_b.detach(), valid_b
            carry, normal, mask = self.step(params, "decoder", carry, obs1, obs2, p1, p2,
                                            weights)
            new_pos = (obs2 + normal[..., :2]) * mask[..., None]
            normals.append(normal)
            masks.append(mask)
            positions.append(new_pos)
            pos_a, valid_a, pos_b, valid_b = obs2, p2, new_pos, mask
        return carry, normals, masks, positions

    # --------------------------------------------------------------- forward
    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None):
        """Full rollout on the device and dtype of ``params``.

        prediction_truth(+mask): [pred_length - 1, S, A, 2] future frames for
        teacher forcing (training), or None with n_predict set (testing).
        Autograd records it unless the caller turns it off.

        Returns (rel_pred [T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]).
        """
        teacher = prediction_truth is not None
        if teacher == (n_predict is not None) or teacher != (prediction_truth_mask is not None):
            raise ValueError("forward needs prediction_truth and its mask, or n_predict")
        if not teacher and n_predict < 1:
            raise ValueError("forward needs n_predict >= 1")
        ref = params["encoder"]["w_ih"]

        def place(x, dtype):
            return torch.as_tensor(x).to(device=ref.device, dtype=dtype).contiguous()

        observed = place(observed, ref.dtype)
        observed_mask = place(observed_mask, torch.bool)
        s, a = observed.shape[1], observed.shape[2]
        carry = self.init_carry(s, a, device=ref.device, dtype=ref.dtype)
        weights = {cell: weights_from_params(params, cell) for cell in ("encoder", "decoder")}
        if (self.fused and ref.device.type == "cuda"
                and not autograd_records(*weights["decoder"].values())):
            # checked against the kernel once here, not at each of its launches
            weights = {cell: check_weights(w, ref.device) for cell, w in weights.items()}

        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, carry, observed, observed_mask, weights["encoder"]
        )

        # the decoder starts from the last observed frame for every
        # neighbour; only the primary reads the model's own positions[-2]
        # (with a 2-frame observation the observation stands in for it), in
        # both teacher-forced and autoregressive modes
        if observed.shape[0] == 2:
            prim_a, prim_valid_a = observed[-1][:, 0], observed_mask[-1][:, 0]
        else:
            prim_a, prim_valid_a = enc_positions[-2][:, 0], enc_masks[-2][:, 0]
        pos_a = observed[-1].clone()
        pos_a[:, 0] = prim_a
        valid_a = observed_mask[-1].clone()
        valid_a[:, 0] = prim_valid_a

        truth = truth_mask = None
        if teacher:
            truth = torch.cat([observed[-1:], place(prediction_truth, ref.dtype)])
            truth_mask = torch.cat([observed_mask[-1:], place(prediction_truth_mask, torch.bool)])
            n_predict = truth.shape[0]
        carry, dec_normals, dec_masks, dec_positions = self.decode(
            params, carry, pos_a, valid_a, enc_positions[-1], enc_masks[-1],
            n_predict - 1, weights["decoder"], truth, truth_mask,
        )
        rel_pred = torch.stack(enc_normals + dec_normals)
        pred = torch.stack(enc_positions + dec_positions)
        valid = torch.stack(enc_masks + dec_masks)
        return rel_pred, pred, valid


def _set_primary(gt_xy, gt_mask, own_xy, own_mask):
    """Ground truth at one frame ``[S, A, ...]`` with the primary's lane
    replaced by the model's own detached position and its validity."""
    xy = gt_xy.clone()
    xy[:, 0] = own_xy[:, 0].detach()
    mask = gt_mask.clone()
    mask[:, 0] = own_mask[:, 0]
    return xy, mask


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
        with torch.no_grad():
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
