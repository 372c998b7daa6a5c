"""LSTM trajectory forecaster: the autoregressive rollout, step by step.

Port of ``trajnetplusplusbaselines_tpu/models/lstm.py`` (``init_params``,
``init_carry``, ``step``, ``encode``, ``decode`` autoregressive or teacher
forced, ``forward`` and ``LSTMPredictor.__call__``), for every interaction
pool of ``ops/pooling``, the goal-conditioned model (``goal_flag``) and
``pool_to_input=False``.

Shapes: observed [T, S, A, 2]; masks [T, S, A] bool; goals [S, A, 2];
slot_mask [S, A] bool (the slot is a real track); outputs (rel_pred
[T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]) with T' = (T_obs - 1) +
(n_predict - 1), of which the trailing ``n_predict`` entries are the
prediction window.  A rollout of 9 observed and 12 predicted frames is 19
serial steps: 8 encoder transitions and 11 decoder steps.  A stateful pool's
state rides in the step's carry through the encoder and the decoder.

Where a step runs is ``LSTM.route``, decided from the configuration (and
from whether autograd records) once per rollout, before any launch:

- ``"fused"``: the fused D-LSTM step of ``ops/cuda/fused_step.py``, one
  kernel launch on the card.  Only a goal-free, ``pool_to_input``,
  ``one_layer`` directional grid with no ``front``, blur or ``pool_size``,
  whose widths are the kernel's compiled ones (``FUSED_DIMS``: n 12,
  embedding 64, pool 256, hidden 128), and only where autograd does not
  record (the kernel has no backward).
- ``"grid"``: every other directional grid whose side ``n * pool_size`` is
  at most ``GRID_MAX_N``.  The kernel's grid stage (``directional_grid``,
  no gradient: positions are data or detached) makes the last-write grid;
  the blur, the pool's embedding (any arch, stateful or not), the goal
  embedding and ``lstm_step_plain`` run in PyTorch under autograd.  Serving
  and training alike.
- ``"plain"``: everything else (vanilla, occupancy, social, dir_social,
  the non-grid pools, a directional grid too large for the grid stage):
  the pool and ``lstm_step_plain`` in PyTorch on either device.

This is routing by configuration, not a fallback: on the card a kernel that
fails to build or launch raises.  On the CPU the wrappers run their plain
versions, so every route computes the same function there; the launch
counters (``fused_dlstm_step.launches``, ``directional_grid.launches``) show
on the card which route ran.  Whether autograd records is the caller's
choice: serving and validation call ``forward`` under ``torch.no_grad()``.
The encoder pools per step: the JAX package's observation-phase fold is an
exact regrouping of the same per-step values (``tests/test_static_pool.py``)
made for the TPU.
"""

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data import Reader, augmentation, batching
from ..ops.core import init_lstm_cell
from ..ops.cuda.fused_step import (
    FUSED_DIMS,
    GRID_MAX_N,
    autograd_records,
    check_weights,
    directional_grid,
    fused_dlstm_step,
    lstm_step_plain,
    lstm_weights,
    weights_from_params,
)
from ..ops.embeddings import init_hidden2normal, init_input_embedding, input_embedding
from ..ops.pooling.grid import GridBasedPooling


class StepCarry(NamedTuple):
    h: torch.Tensor  # [S, A, H]
    c: torch.Tensor  # [S, A, H]
    pool_state: object = None  # a stateful pool's (h, c), else None


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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
        self.embedding_dim = embedding_dim
        self.hidden_dim = hidden_dim
        self.pool = pool
        self.pool_to_input = pool_to_input
        self.goal_flag = goal_flag
        self.goal_dim = goal_dim or embedding_dim
        goal_rep = self.goal_dim if goal_flag else 0
        pooling_dim = pool.out_dim if (pool is not None and pool_to_input) else 0
        self.input_dim = embedding_dim + goal_rep + pooling_dim

    # --------------------------------------------------------------- routing
    @property
    def fused(self) -> bool:
        """True when the fused step computes a step of this model: a
        goal-free, ``pool_to_input``, ``one_layer`` directional grid with no
        front, blur or pool_size, at the kernel's compiled widths."""
        pool = self.pool
        return (isinstance(pool, GridBasedPooling) and pool.type_ == "directional"
                and pool.embedding_arch == "one_layer" and not pool.front
                and pool.blur_size == 1 and pool.pool_size == 1
                and not self.goal_flag and self.pool_to_input
                and (pool.n, self.embedding_dim, pool.out_dim, self.hidden_dim)
                == tuple(FUSED_DIMS.values()))

    @property
    def grid_stage(self) -> bool:
        """True when the kernel's grid stage makes this model's grid: a
        directional grid of side ``n * pool_size`` <= ``GRID_MAX_N``."""
        pool = self.pool
        return (isinstance(pool, GridBasedPooling) and pool.type_ == "directional"
                and pool.n * pool.pool_size <= GRID_MAX_N)

    def route(self, records: bool) -> str:
        """The routing predicate: ``"fused"`` where the fused step computes
        the step and autograd does not record (``records``), else ``"grid"``
        where the grid stage makes the grid, else ``"plain"`` (the module's
        docstring gives each route)."""
        if self.fused and not records:
            return "fused"
        return "grid" if self.grid_stage else "plain"

    @staticmethod
    def step_weights(params: Dict, cell: str, route: str):
        """The step's weights for ``route``: on the fused route the fused
        step's (``weights_from_params``), checked against the kernel once
        here on the card; else ``lstm_step_plain``'s (``lstm_weights``)."""
        if route != "fused":
            return lstm_weights(params, cell)
        weights = weights_from_params(params, cell)
        device = params[cell]["w_ih"].device
        return check_weights(weights, device) if device.type == "cuda" else weights

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
        pool_state = (self.pool.init_state(num_scenes, num_agents, device=device, dtype=dtype)
                      if self.pool is not None else None)
        return StepCarry(torch.zeros(shape, device=device, dtype=dtype),
                         torch.zeros(shape, device=device, dtype=dtype), pool_state)

    # ------------------------------------------------------------------ step
    def _goal_input(self, params, obs2, goals, mask):
        """The goal embedding of the unit direction to the goal; zero where
        the agent is on its goal or not moving, with no NaN in the gradient
        (the norm is divided only where it is positive)."""
        diff = (obs2 - goals) * mask[..., None]
        norm = torch.linalg.vector_norm(diff, dim=-1, keepdim=True)
        pos = norm > 0
        direction = torch.where(pos, diff / torch.where(pos, norm, torch.ones_like(norm)),
                                torch.zeros_like(diff))
        return input_embedding(params["goal_embedding"], direction)

    def step(self, params: Dict, cell_name: str, carry: StepCarry, obs1, obs2,
             present1, present2, weights: Optional[Dict] = None, *, goals=None,
             slot_mask=None, route: Optional[str] = None):
        """One recurrence step. Returns (carry, normal [S,A,5], mask [S,A]).

        route: ``self.route(...)``, decided once per rollout by ``forward``;
        None decides it here.  weights: ``step_weights(params, cell_name,
        route)``, made once per rollout by ``forward``; None makes them here."""
        if route is None:
            route = self.route(autograd_records(carry.h, carry.c, *_leaves(params)))
        if weights is None:
            weights = self.step_weights(params, cell_name, route)
        pool = self.pool
        if route == "fused":
            h, c, normal, mask = fused_dlstm_step(
                obs1, obs2, present1, present2, carry.h, carry.c, weights,
                n=pool.n, cell_side=pool.cell_side, constant=pool.constant,
            )
            return StepCarry(h, c, carry.pool_state), normal, mask

        mask = present1 & present2
        inputs, h_in, pool_state = [], None, carry.pool_state
        if self.goal_flag:
            inputs.append(self._goal_input(params, obs2, goals, mask))
        if pool is not None:
            kw = ({"raw_grid": directional_grid(obs1, obs2, present1, present2,
                                                **pool.grid_stage_args)}
                  if route == "grid" else {})
            pooled, pool_state = pool.apply(params["pool"], carry.pool_state, carry.h, obs1,
                                            obs2, present1, present2, slot_mask, **kw)
            if self.pool_to_input:
                inputs.append(pooled)
            else:
                h_in = carry.h + pooled * mask[..., None]
        h, c, normal, mask = lstm_step_plain(weights, obs1, obs2, present1, present2,
                                             carry.h, carry.c, *inputs, h_in=h_in)
        return StepCarry(h, c, pool_state), normal, mask

    # --------------------------------------------------------------- encoder
    def encode(self, params, carry, observed, observed_mask, weights=None, *, goals=None,
               slot_mask=None, route=None):
        """Run the encoder over the observation transitions.

        Returns (carry, normals, masks, positions), each a list of T-1
        per-step tensors."""
        normals: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        positions: List[torch.Tensor] = []
        for t in range(observed.shape[0] - 1):
            carry, normal, mask = self.step(
                params, "encoder", carry, observed[t], observed[t + 1],
                observed_mask[t], observed_mask[t + 1], weights, goals=goals,
                slot_mask=slot_mask, route=route,
            )
            normals.append(normal)
            masks.append(mask)
            positions.append((observed[t + 1] + normal[..., :2]) * mask[..., None])
        return carry, normals, masks, positions

    # --------------------------------------------------------------- decoder
    def decode(self, params, carry, pos_a, valid_a, pos_b, valid_b, n_steps: int,
               weights=None, truth=None, truth_mask=None, *, goals=None, slot_mask=None,
               route=None):
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
                                            weights, goals=goals, slot_mask=slot_mask,
                                            route=route)
            new_pos = (obs2 + normal[..., :2]) * mask[..., None]
            normals.append(normal)
            masks.append(mask)
            positions.append(new_pos)
            pos_a, valid_a, pos_b, valid_b = obs2, p2, new_pos, mask
        return carry, normals, masks, positions

    # --------------------------------------------------------------- forward
    def forward(self, params: Dict, observed, observed_mask, prediction_truth=None,
                prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                goals=None, slot_mask=None):
        """Full rollout on the device and dtype of ``params``.

        prediction_truth(+mask): [pred_length - 1, S, A, 2] future frames for
        teacher forcing (training), or None with n_predict set (testing).
        goals [S, A, 2]: needed by a goal model, else unused.  slot_mask
        [S, A]: the slots that are real tracks, needed by a pool that reads
        it (``pool.reads_slot_mask``), else unused.  Autograd records it
        unless the caller turns it off.

        Returns (rel_pred [T', S, A, 5], pred [T', S, A, 2], valid [T', S, A]).
        """
        teacher = prediction_truth is not None
        if teacher == (n_predict is not None) or teacher != (prediction_truth_mask is not None):
            raise ValueError("forward needs prediction_truth and its mask, or n_predict")
        if not teacher and n_predict < 1:
            raise ValueError("forward needs n_predict >= 1")
        if self.goal_flag and goals is None:
            raise ValueError("a goal-conditioned model needs goals")
        if getattr(self.pool, "reads_slot_mask", False) and slot_mask is None:
            raise ValueError(f"{type(self.pool).__name__} reads the slot mask: pass slot_mask")
        ref = params["encoder"]["w_ih"]

        def place(x, dtype):
            return torch.as_tensor(x).to(device=ref.device, dtype=dtype).contiguous()

        observed = place(observed, ref.dtype)
        observed_mask = place(observed_mask, torch.bool)
        goals = place(goals, ref.dtype) if goals is not None else None
        slot_mask = place(slot_mask, torch.bool) if slot_mask is not None else None
        s, a = observed.shape[1], observed.shape[2]
        carry = self.init_carry(s, a, device=ref.device, dtype=ref.dtype)
        route = self.route(autograd_records(*_leaves(params)))
        weights = {cell: self.step_weights(params, cell, route)
                   for cell in ("encoder", "decoder")}
        kw = dict(goals=goals, slot_mask=slot_mask, route=route)

        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, carry, observed, observed_mask, weights["encoder"], **kw
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
            n_predict - 1, weights["decoder"], truth, truth_mask, **kw,
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
    ``params``; the model is deterministic, so every mode is the same.  A
    goal model reads ``scene_goal`` [n, 2], centred with the scene under
    ``normalize_scene``; other models ignore it."""

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
        xy = Reader.paths_to_xy(paths)
        goal_flag = self.model.goal_flag
        scene_goal = np.asarray(scene_goal, dtype=np.float32) if goal_flag else None
        normalize = bool(getattr(args, "normalize_scene", False)) if args is not None else False
        if normalize:
            xy, rotation, center, *goal = augmentation.center_scene(xy, obs_length,
                                                                    goals=scene_goal)
            scene_goal = goal[0] if goal_flag else None

        packed = batching.pack_scenes([xy[start_length:obs_length]])
        goals = np.zeros((1, packed.max_agents, 2), dtype=np.float32)
        if goal_flag:
            goals[0, : scene_goal.shape[0]] = scene_goal[: packed.max_agents]
        slot_mask = np.arange(packed.max_agents)[None, :] < packed.num_agents[:, None]
        with torch.no_grad():
            _, pred, valid = self.model.forward(
                self.params, torch.from_numpy(packed.xy), torch.from_numpy(packed.mask),
                n_predict=n_predict, goals=torch.from_numpy(goals),
                slot_mask=torch.from_numpy(slot_mask),
            )
        output = batching.mask_to_nan(pred.cpu().numpy(), valid.cpu().numpy())
        output = output[:, 0, : xy.shape[1]]  # [T', A, 2]
        if normalize:
            output = augmentation.inverse_scene(output, rotation, center)
        return {mode: [output[-n_predict:, 0], output[-n_predict:, 1:]]
                for mode in range(modes)}
