"""Grid-based interaction pooling: occupancy, directional, social, dir_social.

Port of ``trajnetplusplusbaselines_tpu/ops/pooling/grid.py``: the four grid
types, the ``one_layer`` / ``two_layer`` / ``three_layer`` / ``"None"``
embeddings, the stateful ``lstm_layer`` embedding, ``front``, ``blur_size``
and ``pool_size``.  The JAX package keeps five interchangeable last-write-wins
scatter forms, proven bit-identical by ``tests/test_grid_scatter.py``; this
port has one, the winner reduction of ``_winner_reduce`` followed by a gather
of the winner's value.

Semantics (parity-critical, bit-exact against the JAX ``make_grid``):
- with ``nps = n * pool_size``, the cell of neighbour j in agent i's grid is
  ``floor((pos_j - pos_i) / (cell_side / pool_size) + offset)``, computed
  with a true division; the offset is ``(nps/2, nps/2)``, or ``(nps/2, 0)``
  with ``front``;
- duplicate cells resolve to the highest neighbour index j;
- every non-self neighbour writes: an out-of-range or invisible one (either
  end absent at t) writes ``constant`` into cell 0;
- the directional value is the relative velocity, zero unless both agents
  are present at t-1 and t; the social value is neighbour j's encoded hidden
  state, dir_social both (one winner for the two);
- channel-major flatten: ``[S, A, D, nps, nps]``;
- then the blur (a stride-1 average with zero padding ``int(b/2)`` counted in
  the divisor, so an even blur grows the map by 1, as in JAX) and the
  ``pool_size`` reduction (a strided sum, the p=1 lp-pool).

The winner is an integer index, outside the autograd graph; the gather of
the winner's value is differentiable, so a social grid's gradient reaches the
LSTM's hidden state and ``hidden_dim_encoding``.  Positions get no gradient.

On the card the directional grid is the kernel's grid stage
(``ops/cuda/fused_step.directional_grid``), routed by ``models/lstm.py``,
which hands it to ``apply`` / ``make_grid`` as ``raw_grid``; this module is
the plain version and everything after the last write.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core import init_linear, init_lstm_cell, init_mlp, linear, lstm_cell, mlp


def winner_reduce(write_cell: torch.Tensor, write_valid: torch.Tensor, g: int) -> torch.Tensor:
    """winner[s, i, g] = highest valid j writing cell g, -1 if none.

    write_cell [S, A, A] int64, write_valid [A, A] or [S, A, A] bool."""
    a = write_cell.shape[2]
    cell_iota = torch.arange(g, device=write_cell.device)
    j_iota = torch.arange(a, dtype=torch.int32, device=write_cell.device)
    hit = (write_cell[..., None] == cell_iota) & write_valid[..., None]  # [S, A, A, G]
    return torch.where(hit, j_iota[:, None], -1).amax(dim=2)  # [S, A, G]


def last_write_grid(write_cell, write_value, write_valid, constant: float, g: int):
    """Grid [S, A, G, D] of the values that win each cell, ``constant`` where
    no neighbour writes."""
    winner = winner_reduce(write_cell, write_valid, g)
    s, a, _, d = write_value.shape
    index = winner.clamp(min=0).long()[..., None].expand(s, a, g, d)
    gathered = torch.gather(write_value, 2, index)
    return torch.where((winner >= 0)[..., None], gathered,
                       torch.full_like(gathered, constant))


class GridBasedPooling:
    """Static configuration for grid pooling; parameters live in a dict."""

    def __init__(
        self,
        type_: str = "occupancy",
        hidden_dim: int = 128,
        cell_side: float = 2.0,
        n: int = 4,
        out_dim: Optional[int] = None,
        pool_size: int = 1,
        blur_size: int = 1,
        front: bool = False,
        embedding_arch: str = "one_layer",
        constant: float = 0.0,
        norm: int = 0,
        layer_dims: Optional[list] = None,
        latent_dim: int = 16,
    ):
        if type_ not in ("occupancy", "directional", "social", "dir_social"):
            raise ValueError(f"unknown grid pool type {type_!r}")
        if embedding_arch not in ("one_layer", "two_layer", "three_layer", "lstm_layer", "None"):
            raise ValueError(f"unknown embedding_arch {embedding_arch!r}")
        self.type_ = type_
        self.hidden_dim = hidden_dim
        self.cell_side = float(cell_side)
        self.n = n
        self.pool_size = pool_size
        self.blur_size = blur_size
        self.front = front
        self.constant = float(constant)
        self.norm = norm
        self.latent_dim = latent_dim
        self.embedding_arch = embedding_arch
        self.layer_dims = list(layer_dims) if layer_dims else [512]
        self.pooling_dim = {"occupancy": 1, "directional": 2, "social": latent_dim,
                            "dir_social": latent_dim + 2}[type_]
        self.out_dim = out_dim if out_dim is not None else hidden_dim
        self.grid_dim = self.n * self.n * self.pooling_dim
        self.stateful = embedding_arch == "lstm_layer"

    @property
    def reads_slot_mask(self) -> bool:
        """The stateful embedding updates only the scene's real tracks."""
        return self.stateful

    @property
    def grid_stage_args(self) -> Dict:
        """The raw grid's geometry, as ``directional_grid`` takes it: the
        side ``n * pool_size`` and the cell side ``cell_side / pool_size``."""
        return {"n": self.n * self.pool_size, "cell_side": self.cell_side / self.pool_size,
                "constant": self.constant, "front": self.front}

    # ---------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params: Dict = {}
        if self.type_ in ("social", "dir_social"):
            params["hidden_dim_encoding"] = init_linear(generator, self.hidden_dim,
                                                        self.latent_dim, **kw)
        widths = {"one_layer": [], "two_layer": self.layer_dims[:1],
                  "three_layer": self.layer_dims[:2], "lstm_layer": []}
        if self.embedding_arch in widths:
            dims = [self.grid_dim, *widths[self.embedding_arch], self.out_dim]
            params["embedding"] = init_mlp(generator, dims, **kw)
        if self.stateful:
            params["pool_lstm"] = init_lstm_cell(generator, self.out_dim, self.hidden_dim, **kw)
            params["hidden2pool"] = init_linear(generator, self.hidden_dim, self.out_dim, **kw)
        return params

    def init_state(self, num_scenes: int, num_agents: int, device=None, dtype=torch.float32):
        if not self.stateful:
            return None
        shape = (num_scenes, num_agents, self.hidden_dim)
        return (torch.zeros(shape, device=device, dtype=dtype),
                torch.zeros(shape, device=device, dtype=dtype))

    # ----------------------------------------------------------------- grids
    def _grid_values(self, hidden, obs1, obs2, present1, present2, params):
        """Per-pair fill values [S, A, A, D]: value[s, i, j] is what j writes
        in i's grid."""
        s, a = obs2.shape[:2]
        if self.type_ == "occupancy":
            return obs2.new_ones((s, a, a, 1))
        vel_valid = present1 & present2
        vel = (obs2 - obs1) * vel_valid[..., None]
        both = vel_valid[:, None, :] & vel_valid[:, :, None]
        rel_vel = (vel[:, None, :, :] - vel[:, :, None, :]) * both[..., None]
        if self.type_ == "directional":
            return rel_vel
        hidden_enc = linear(params["hidden_dim_encoding"], hidden)  # [S, A, latent]
        hidden_grid = hidden_enc[:, None, :, :].expand(s, a, a, self.latent_dim)
        if self.type_ == "social":
            return hidden_grid
        return torch.cat([rel_vel, hidden_grid], dim=-1)  # dir_social

    def last_write(self, obs1, obs2, present1, present2, hidden=None, params=None):
        """The last-write grid ``[S, A, D, nps, nps]`` before blur and
        ``pool_size``, from positions ``[S, A, 2]`` at t-1 and t, presence
        masks ``[S, A]`` and, for the social types, the hidden state
        ``[S, A, H]`` and the pool's params."""
        s, a = obs2.shape[:2]
        nps = self.n * self.pool_size
        values = self._grid_values(hidden, obs1, obs2, present1, present2, params)

        rel = obs2[:, None, :, :] - obs2[:, :, None, :]  # rel[s, i, j] = pos_j - pos_i
        # a tensor divisor: PyTorch turns division by a Python scalar on the
        # card into a multiply by its reciprocal, which moves neighbours that
        # sit on a cell boundary into the next cell
        side = torch.tensor(self.cell_side / self.pool_size, dtype=rel.dtype, device=rel.device)
        offset = torch.tensor([nps / 2.0, 0.0 if self.front else nps / 2.0], dtype=rel.dtype,
                              device=rel.device)
        oij = rel / side + offset

        visible = present2[:, None, :] & present2[:, :, None]
        not_self = ~torch.eye(a, dtype=torch.bool, device=obs2.device)
        in_range = ((oij >= 0) & (oij < nps)).all(dim=-1) & visible & not_self

        cell = torch.floor(oij).long()
        flat_cell = cell[..., 0] * nps + cell[..., 1]
        write_cell = torch.where(in_range, flat_cell, 0)
        write_value = torch.where(in_range[..., None], values,
                                  torch.full_like(values, self.constant))
        grid = last_write_grid(write_cell, write_value, not_self, self.constant, nps * nps)
        return grid.reshape(s, a, nps, nps, -1).movedim(-1, 2)

    def make_grid(self, obs1, obs2, present1, present2, hidden=None, params=None,
                  raw_grid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pooled grid ``[S, A, D, n', n']``: the last-write grid, then
        the blur and the ``pool_size`` sum.  ``raw_grid``: the last-write grid
        made elsewhere (the kernel's grid stage), flat or not; None makes it
        here."""
        s, a = obs2.shape[:2]
        nps = self.n * self.pool_size
        if raw_grid is None:
            grid = self.last_write(obs1, obs2, present1, present2, hidden, params)
        else:
            grid = raw_grid.reshape(s, a, -1, nps, nps)
        d = grid.shape[2]
        if self.blur_size > 1:
            b = self.blur_size
            summed = F.avg_pool2d(grid.reshape(s * a, d, nps, nps), b, stride=1, padding=b // 2,
                                  count_include_pad=True, divisor_override=1)
            grid = (summed / float(b ** 2)).reshape(s, a, d, *summed.shape[-2:])
        if self.pool_size > 1:
            p = self.pool_size
            side = grid.shape[-1]
            summed = F.avg_pool2d(grid.reshape(s * a, d, side, side), p, stride=p,
                                  divisor_override=1)
            grid = summed.reshape(s, a, d, *summed.shape[-2:])
        return grid

    # ----------------------------------------------------------------- apply
    def apply(self, params: Dict, state, hidden, obs1, obs2, present1, present2,
              slot_mask: Optional[torch.Tensor] = None,
              raw_grid: Optional[torch.Tensor] = None):
        """Pooled interaction features ``[S, A, out_dim]`` and the pool's next
        state (None unless ``lstm_layer``)."""
        s, a = obs2.shape[:2]
        flat = self.make_grid(obs1, obs2, present1, present2, hidden, params,
                              raw_grid).reshape(s, a, -1)
        if self.embedding_arch == "None":
            return flat, state
        emb = mlp(params["embedding"], flat)
        if not self.stateful:
            return emb, state

        # the stateful lstm_layer embedding: only tracks taking part in the
        # step (and real slots) update their interaction-LSTM state, and a
        # scene with <= 1 such track contributes zeros and keeps its state
        vis = present1 & present2
        if slot_mask is not None:
            vis = vis & slot_mask
        multi = vis.sum(dim=1, keepdim=True) > 1  # [S, 1]
        upd = (vis & multi)[..., None]
        h, c = state
        h_new, c_new = lstm_cell(params["pool_lstm"], emb, (h, c))
        h_new = torch.where(upd, h_new, h)
        c_new = torch.where(upd, c_new, c)
        return linear(params["hidden2pool"], h_new) * multi[..., None], (h_new, c_new)
