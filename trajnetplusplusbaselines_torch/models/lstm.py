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
``start_decoder`` makes what the decoder starts from; the generative models
(``models/sgan.py``, ``models/vae.py``) change its hidden state and repeat
it along the scene axis to decode k modes as one batch
(``DecoderStart.repeat``).

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
  the non-grid pools, a directional grid too large for the grid stage, a
  directional grid whose positions carry a gradient, as an SGAN
  discriminator's are when it scores the generator's rollout in a generator
  step): the pool and ``lstm_step_plain`` in PyTorch on either device.

Above the step routes, a whole rollout takes ``fused_train`` where
``LSTM.takes_fused_train`` holds: a teacher-forced ``forward`` that autograd
records, of a goal-free, ``pool_to_input`` directional grid of the grid
stage with the ``one_layer`` embedding and no blur or ``pool_size``, widths
the cell kernels take (``fused_train.takes_widths``), not in bf16 (on
the card only in f32, the kernels' dtype) and not under ``remat``.  A
``--tp`` trainer gathers the full params before ``forward``, so it takes
the route as one process does.  There ``ops/cuda/fused_train.FusedTrainRollout``
computes the rollout with a hand-written backward: per step the grid stage
(the name this module imports, ``directional_grid``) and two kernels
forward, one kernel backward, each kernel forming the step's products
itself.  Every other rollout steps through ``step`` on its step route.

The route also follows the compute dtype (``with_dtype``): the fused step
is an f32 kernel, so a model that computes in bf16 takes ``"grid"`` for
its directional grid, whose grid stage then runs in bf16 (the grid stage
has a bf16 instantiation), or ``"plain"``.

This is routing by configuration, not a fallback: on the card a kernel that
fails to build or launch raises.  On the CPU the wrappers run their plain
versions, so every route computes the same function there; the launch
counters (``fused_dlstm_step.launches``, ``directional_grid.launches``) show
on the card which route ran.  Whether autograd records is the caller's
choice: serving and validation call ``forward`` under ``torch.no_grad()``.
The encoder pools per step: the JAX package's observation-phase fold is an
exact regrouping of the same per-step values (``tests/test_static_pool.py``)
made for the TPU.

Compute dtype and remat, as the JAX package's ``with_dtype`` and ``remat``:
``compute_dtype`` (None or ``torch.bfloat16``) is the dtype the trainers
cast the params to inside the differentiated loss
(``trainers/common.cast_compute``) and the predictors cast them to for
serving; the positions, goals, carry and pool state follow the params'
dtype (``place_inputs``, ``init_carry``).  ``remat`` wraps each encoder and
decoder step in ``torch.utils.checkpoint`` (non-reentrant) where autograd
records: the step's activations are recomputed in the backward instead of
kept, values and gradients unchanged.  ``encode`` and ``decode`` take the
step to call (``step=``): the seed-ensemble trainer gives them the step
vmapped over its members (``trainers/ensemble.py``), so the rollout loop
stays outside the vmap.  The decoder's primary lane is indexed from the
right (``[..., 0, :]``), so the loop takes a leading member axis.
"""

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
from ..ops.cuda.fused_train import fused_train_rollout, takes_widths
from ..ops.embeddings import init_hidden2normal, init_input_embedding, input_embedding
from ..ops.pooling.grid import GridBasedPooling
from ..utils.convert import params_to


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
        self.compute_dtype: Optional[torch.dtype] = None  # None: the params' own dtype
        self.remat = False

    def with_dtype(self, dtype: Optional[torch.dtype]) -> "LSTM":
        """Compute in ``dtype`` (None: the params' dtype); returns self."""
        self.compute_dtype = dtype
        return self

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

    def route(self, records: bool, positions_record: bool = False,
              dtype: torch.dtype = torch.float32) -> str:
        """The routing predicate: ``"fused"`` where the fused step computes
        the step, autograd does not record (``records``) and the step does
        not compute in bf16 (``dtype``), else ``"grid"`` where the grid stage
        makes the grid and the positions carry no gradient
        (``positions_record``: a discriminator scoring a generator's
        rollout), else ``"plain"`` (the module's docstring gives each
        route)."""
        if self.fused and not records and dtype != torch.bfloat16:
            return "fused"
        return "grid" if self.grid_stage and not positions_record else "plain"

    @property
    def fused_train(self) -> bool:
        """True when ``FusedTrainRollout`` computes this model's rollout
        under autograd: a goal-free, ``pool_to_input`` directional grid of
        the grid stage with the ``one_layer`` embedding and no blur or
        ``pool_size``, widths the cell kernels take (``fused_train.takes_widths``:
        at most ``MAX_HIDDEN`` units), not under ``remat``."""
        pool = self.pool
        return (self.grid_stage and pool.embedding_arch == "one_layer"
                and pool.blur_size == 1 and pool.pool_size == 1 and not self.goal_flag
                and self.pool_to_input and takes_widths(self.input_dim, self.hidden_dim)
                and not self.remat)

    def takes_fused_train(self, records: bool, teacher: bool, positions_record: bool = False,
                          dtype: torch.dtype = torch.float32, device="cpu") -> bool:
        """The routing predicate of a whole rollout, beside ``route``: True
        where ``forward`` runs ``FusedTrainRollout``, a ``fused_train``
        model (above) whose rollout autograd records on the params
        (``records``), teacher-forced (``teacher``), with positions that
        carry no gradient (``positions_record``), in the params' ``dtype``
        on their ``device``: float32 on the card, whose kernels are f32; on
        the CPU any float dtype but bf16, which takes ``route``'s bf16 grid
        stage as on the card.  Elsewhere each step takes ``route``'s route."""
        on_card = torch.device(device).type == "cuda"
        return (records and teacher and not positions_record and self.fused_train
                and (dtype == torch.float32 if on_card else dtype != torch.bfloat16))

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
            route = self.route(autograd_records(carry.h, carry.c, *_leaves(params)),
                               dtype=carry.h.dtype)
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

    def step_fn(self, params: Dict):
        """``step`` as ``encode`` and ``decode`` call it by default: under
        ``remat``, and where autograd records on ``params``, each call is
        checkpointed."""
        if not (self.remat and autograd_records(*_leaves(params))):
            return self.step

        def remat_step(*args, **kwargs):
            # the step draws no random numbers, so there is no RNG state to
            # keep for its recomputation (reading the card's would refuse a
            # CUDA graph's capture)
            return checkpoint(self.step, *args, use_reentrant=False, preserve_rng_state=False,
                              **kwargs)

        return remat_step

    # --------------------------------------------------------------- encoder
    def encode(self, params, carry, observed, observed_mask, weights=None, *, goals=None,
               slot_mask=None, route=None, step=None):
        """Run the encoder over the observation transitions.  ``step``: the
        step function, ``step_fn(params)`` by default.

        Returns (carry, normals, masks, positions), each a list of T-1
        per-step tensors."""
        step = step or self.step_fn(params)
        normals: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        positions: List[torch.Tensor] = []
        for t in range(observed.shape[0] - 1):
            carry, normal, mask = step(
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
               route=None, step=None):
        """Run the decoder for n_steps from the last two positions.

        truth / truth_mask: [n_steps + 1, S, A, ...] ground-truth chain
        starting at the last observed frame (teacher forcing); None for full
        autoregression.  The primary (agent 0) always reads the model's own
        detached position, and in autoregression every agent does.

        ``step``: the step function, ``step_fn(params)`` by default.

        Returns (carry, normals, masks, positions), each a list of n_steps
        per-step tensors."""
        step = step or self.step_fn(params)
        normals, masks, positions = [], [], []
        for k in range(n_steps):
            if truth is not None:
                obs1, p1 = _set_primary(truth[k], truth_mask[k], pos_a, valid_a)
                obs2, p2 = _set_primary(truth[k + 1], truth_mask[k + 1], pos_b, valid_b)
            else:
                obs1, p1, obs2, p2 = pos_a.detach(), valid_a, pos_b.detach(), valid_b
            carry, normal, mask = step(params, "decoder", carry, obs1, obs2, p1, p2,
                                       weights, goals=goals, slot_mask=slot_mask, route=route)
            new_pos = (obs2 + normal[..., :2]) * mask[..., None]
            normals.append(normal)
            masks.append(mask)
            positions.append(new_pos)
            pos_a, valid_a, pos_b, valid_b = obs2, p2, new_pos, mask
        return carry, normals, masks, positions

    # --------------------------------------------------------------- forward
    def inputs(self, params: Dict, observed, observed_mask, prediction_truth=None,
               prediction_truth_mask=None, n_predict: Optional[int] = None, *, goals=None,
               slot_mask=None) -> "Inputs":
        """A rollout's inputs on the device and in the dtype of ``params``,
        contiguous (``place_inputs``).  Raises unless it has the truth and its
        mask (teacher forcing) or ``n_predict`` >= 1."""
        teacher = prediction_truth is not None
        if teacher == (n_predict is not None) or teacher != (prediction_truth_mask is not None):
            raise ValueError("forward needs prediction_truth and its mask, or n_predict")
        if not teacher and n_predict < 1:
            raise ValueError("forward needs n_predict >= 1")
        return self.place_inputs(params, observed, observed_mask, prediction_truth,
                                 prediction_truth_mask, n_predict, goals=goals,
                                 slot_mask=slot_mask)

    def place_inputs(self, params: Dict, observed, observed_mask, prediction_truth=None,
                     prediction_truth_mask=None, n_predict: Optional[int] = None, *,
                     goals=None, slot_mask=None) -> "Inputs":
        """``Inputs`` on the device and in the dtype of ``params``,
        contiguous.  Raises without goals for a goal model or without the
        slot mask for a pool that reads it."""
        if self.goal_flag and goals is None:
            raise ValueError("a goal-conditioned model needs goals")
        if getattr(self.pool, "reads_slot_mask", False) and slot_mask is None:
            raise ValueError(f"{type(self.pool).__name__} reads the slot mask: pass slot_mask")
        ref = params["encoder"]["w_ih"]

        def place(x, dtype):
            if x is None:
                return None
            return torch.as_tensor(x).to(device=ref.device, dtype=dtype).contiguous()

        return Inputs(place(observed, ref.dtype), place(observed_mask, torch.bool),
                      place(prediction_truth, ref.dtype), place(prediction_truth_mask, torch.bool),
                      n_predict, place(goals, ref.dtype), place(slot_mask, torch.bool))

    def plan(self, params: Dict, cells, *positions) -> tuple:
        """(route, {cell: step weights}) of one rollout, decided before any
        launch (``route``) from the params and, where they carry a gradient,
        the ``positions`` the rollout reads."""
        records = autograd_records(*_leaves(params), *positions)
        route = self.route(records, positions_record=autograd_records(*positions),
                           dtype=params["encoder"]["w_ih"].dtype)
        return route, {cell: self.step_weights(params, cell, route) for cell in cells}

    def start_decoder(self, carry: StepCarry, x: "Inputs", enc_positions, enc_masks
                      ) -> "DecoderStart":
        """Where the decoder starts after the encoder ran over ``x.observed``:
        every neighbour from the last observed frame, the primary from the
        model's own positions[-2] (with a 2-frame observation the observation
        stands in for it), all from positions[-1]; with truth, the
        teacher-forcing chain ``observed[-1] ++ truth``, else ``n_predict - 1``
        free steps."""
        observed, observed_mask = x.observed, x.observed_mask
        if observed.shape[0] == 2:
            prim_a, prim_valid_a = observed[-1][..., 0, :], observed_mask[-1][..., 0]
        else:
            prim_a, prim_valid_a = enc_positions[-2][..., 0, :], enc_masks[-2][..., 0]
        pos_a = observed[-1].clone()
        pos_a[..., 0, :] = prim_a
        valid_a = observed_mask[-1].clone()
        valid_a[..., 0] = prim_valid_a

        truth = truth_mask = None
        n_steps = (x.n_predict or 0) - 1
        if x.truth is not None:
            truth = torch.cat([observed[-1:], x.truth])
            truth_mask = torch.cat([observed_mask[-1:], x.truth_mask])
            n_steps = truth.shape[0] - 1
        return DecoderStart(carry, pos_a, valid_a, enc_positions[-1], enc_masks[-1], n_steps,
                            truth, truth_mask, x.goals, x.slot_mask)

    def decode_from(self, params, start: "DecoderStart", weights, route: str, step=None):
        """``decode`` from ``start``; returns (carry, normals, masks, positions)."""
        return self.decode(params, start.carry, start.pos_a, start.valid_a, start.pos_b,
                           start.valid_b, start.n_steps, weights, start.truth, start.truth_mask,
                           goals=start.goals, slot_mask=start.slot_mask, route=route, step=step)

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
        x = self.inputs(params, observed, observed_mask, prediction_truth, prediction_truth_mask,
                        n_predict, goals=goals, slot_mask=slot_mask)
        w_ih = params["encoder"]["w_ih"]
        if self.takes_fused_train(autograd_records(*_leaves(params)), x.truth is not None,
                                  autograd_records(x.observed, x.truth), w_ih.dtype,
                                  w_ih.device):
            args = self.pool.grid_stage_args
            return fused_train_rollout(
                params, x.observed, x.observed_mask, x.truth, x.truth_mask,
                lambda *frames: directional_grid(*frames, **args))
        route, weights = self.plan(params, ("encoder", "decoder"))
        carry, enc_normals, enc_masks, enc_positions = self.encode(
            params, self.init_carry(*x.observed.shape[1:3], device=x.observed.device,
                                    dtype=x.observed.dtype),
            x.observed, x.observed_mask, weights["encoder"], goals=x.goals,
            slot_mask=x.slot_mask, route=route,
        )
        start = self.start_decoder(carry, x, enc_positions, enc_masks)
        _, dec_normals, dec_masks, dec_positions = self.decode_from(params, start,
                                                                    weights["decoder"], route)
        rel_pred = torch.stack(enc_normals + dec_normals)
        pred = torch.stack(enc_positions + dec_positions)
        valid = torch.stack(enc_masks + dec_masks)
        return rel_pred, pred, valid


class Inputs(NamedTuple):
    """A rollout's inputs as ``LSTM.inputs`` places them."""

    observed: torch.Tensor  # [T, S, A, 2]
    observed_mask: torch.Tensor  # [T, S, A] bool
    truth: Optional[torch.Tensor]  # [T', S, A, 2] teacher forcing, else None
    truth_mask: Optional[torch.Tensor]
    n_predict: Optional[int]  # free rollout, else None
    goals: Optional[torch.Tensor]  # [S, A, 2]
    slot_mask: Optional[torch.Tensor]  # [S, A] bool


class DecoderStart(NamedTuple):
    """What ``LSTM.decode`` starts from, as ``LSTM.start_decoder`` makes it."""

    carry: StepCarry
    pos_a: torch.Tensor  # [S, A, 2]: positions at the decoder's first t-1
    valid_a: torch.Tensor
    pos_b: torch.Tensor  # [S, A, 2]: positions at its first t
    valid_b: torch.Tensor
    n_steps: int
    truth: Optional[torch.Tensor]  # [n_steps + 1, S, A, 2] teacher-forcing chain, else None
    truth_mask: Optional[torch.Tensor]
    goals: Optional[torch.Tensor]
    slot_mask: Optional[torch.Tensor]

    def repeat(self, modes: int) -> "DecoderStart":
        """Every field, the carry and a stateful pool's state included,
        repeated ``modes`` times along the scene axis, mode-major: the modes
        decode as one batch of ``modes * S`` scenes, mode m in rows
        ``m * S .. (m + 1) * S - 1``."""
        if modes == 1:
            return self

        def rep(x, dim=0):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(rep(v, dim) for v in x)
            return torch.cat([x] * modes, dim=dim)

        carry = StepCarry(rep(self.carry.h), rep(self.carry.c), rep(self.carry.pool_state))
        return DecoderStart(carry, rep(self.pos_a), rep(self.valid_a), rep(self.pos_b),
                            rep(self.valid_b), self.n_steps, rep(self.truth, 1),
                            rep(self.truth_mask, 1), rep(self.goals), rep(self.slot_mask))

    def with_hidden(self, h: torch.Tensor) -> "DecoderStart":
        return self._replace(carry=self.carry._replace(h=h))


def join_modes(enc: List[torch.Tensor], dec: List[torch.Tensor], modes: int) -> torch.Tensor:
    """``[modes, T_enc + T_dec, S, ...]`` from the encoder's per-step tensors
    ``[S, ...]``, which the modes share, and the decoder's ``[modes * S, ...]``
    (``DecoderStart.repeat``)."""
    enc = torch.stack(enc)
    enc = enc[None].expand(modes, *enc.shape)
    if not dec:
        return enc
    dec = torch.stack(dec)
    dec = dec.reshape(dec.shape[0], modes, enc.shape[2], *dec.shape[2:]).movedim(1, 0)
    return torch.cat([enc, dec], dim=1)


def _set_primary(gt_xy, gt_mask, own_xy, own_mask):
    """Ground truth at one frame (positions ``[..., S, A, 2]``, masks
    ``[..., S, A]``) with the primary's lane replaced by the model's own
    detached position and its validity."""
    xy = gt_xy.clone()
    xy[..., 0, :] = own_xy[..., 0, :].detach()
    mask = gt_mask.clone()
    mask[..., 0] = own_mask[..., 0]
    return xy, mask


def scene_batch(paths, scene_goal, obs_length: int, start_length: int, args, goal_flag: bool):
    """One scene of paths as a batch of one for ``forward``: (observed [T, 1,
    A, 2], mask, goals [1, A, 2] (zeros unless ``goal_flag``), slot_mask [1,
    A]) as numpy, and ``finish(pred [..., T', 1, A, 2], valid)``, which gives
    the scene's tracks ``[..., T', n, 2]``, NaN where invalid, moved back
    where ``args.normalize_scene`` centred the scene (with its goals)."""
    xy = Reader.paths_to_xy(paths)
    scene_goal = np.asarray(scene_goal, dtype=np.float32) if goal_flag else None
    normalize = bool(getattr(args, "normalize_scene", False)) if args is not None else False
    if normalize:
        xy, rotation, center, *goal = augmentation.center_scene(xy, obs_length, goals=scene_goal)
        scene_goal = goal[0] if goal_flag else None
    n_agents = xy.shape[1]
    packed = batching.pack_scenes([xy[start_length:obs_length]])
    goals = np.zeros((1, packed.max_agents, 2), dtype=np.float32)
    if goal_flag:
        goals[0, : scene_goal.shape[0]] = scene_goal[: packed.max_agents]
    slot_mask = np.arange(packed.max_agents)[None, :] < packed.num_agents[:, None]

    def finish(pred, valid):
        out = batching.mask_to_nan(pred, valid)[..., 0, :n_agents, :]
        return augmentation.inverse_scene(out, rotation, center) if normalize else out

    return (packed.xy, packed.mask, goals, slot_mask), finish


def compute_params(model, params: Dict) -> Dict:
    """``params`` in ``model.compute_dtype`` (cast), as serving runs them; as
    they are where it is None."""
    dtype = getattr(model, "compute_dtype", None)
    return params if dtype is None else params_to(params, dtype=dtype)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """``x`` on the host as numpy, bf16 as float32 (numpy has no bf16)."""
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def mode_outputs(out: np.ndarray, n_predict: int) -> Dict:
    """``{mode: [primary, neighbours]}`` of one scene's generative modes
    ``[K, T', n, 2]``: mode 0 keeps the neighbours, later modes the primary
    only."""
    return {m: [o[-n_predict:, 0], o[-n_predict:, 1:] if m == 0 else []]
            for m, o in enumerate(out)}


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
        (xy, mask, goals, slot_mask), finish = scene_batch(
            paths, scene_goal, obs_length, start_length, args, self.model.goal_flag)
        with torch.no_grad():
            _, pred, valid = self.model.forward(
                compute_params(self.model, self.params), torch.from_numpy(xy),
                torch.from_numpy(mask), n_predict=n_predict, goals=torch.from_numpy(goals),
                slot_mask=torch.from_numpy(slot_mask),
            )
        output = finish(to_numpy(pred), valid.cpu().numpy())  # [T', n, 2]
        return {mode: [output[-n_predict:, 0], output[-n_predict:, 1:]]
                for mode in range(modes)}
