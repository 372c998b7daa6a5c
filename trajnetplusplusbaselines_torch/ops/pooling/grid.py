"""Grid-based interaction pooling: ``occupancy`` and ``directional``.

Port of ``trajnetplusplusbaselines_tpu/ops/pooling/grid.py`` for the
position-only grids with the ``one_layer`` embedding.  The JAX package keeps
five interchangeable last-write-wins scatter forms, proven bit-identical by
``tests/test_grid_scatter.py``; this port has one, the winner reduction of
``_winner_reduce`` followed by a gather of the winner's value.

Semantics (parity-critical, bit-exact against the JAX ``make_grid``):
- cell of neighbour j in agent i's grid: ``floor((pos_j - pos_i) / cell_side
  + n / 2)``, computed with a true division;
- duplicate cells resolve to the highest neighbour index j;
- every non-self neighbour writes: an out-of-range or invisible one (either
  end absent at t) writes ``constant`` into cell 0;
- the directional value is the relative velocity, zero unless both agents
  are present at t-1 and t;
- channel-major flatten: ``[S, A, D, n, n]``.

On the card the fused step kernel computes this grid itself
(``ops/cuda/fused_step.py``); this module is the plain version.
"""

from typing import Dict, Optional

import torch

from ..core import init_mlp, mlp


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
        if type_ not in ("occupancy", "directional"):
            raise NotImplementedError(f"grid pool type {type_!r} is not ported yet")
        if embedding_arch != "one_layer":
            raise NotImplementedError(f"grid embedding {embedding_arch!r} is not ported yet")
        if front or blur_size > 1 or pool_size > 1:
            raise NotImplementedError("front, blur_size > 1 and pool_size > 1 are not ported yet")
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
        self.pooling_dim = 2 if type_ == "directional" else 1
        self.out_dim = out_dim if out_dim is not None else hidden_dim
        self.grid_dim = self.n * self.n * self.pooling_dim

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        return {"embedding": init_mlp(generator, [self.grid_dim, self.out_dim],
                                      device=device, dtype=dtype)}

    def make_grid(self, obs1, obs2, present1, present2) -> torch.Tensor:
        """The grid ``[S, A, D, n, n]`` from positions ``[S, A, 2]`` at t-1
        and t and presence masks ``[S, A]``."""
        s, a = obs2.shape[:2]
        g = self.n * self.n
        if self.type_ == "occupancy":
            values = obs2.new_ones((s, a, a, 1))
        else:
            vel_valid = present1 & present2
            vel = (obs2 - obs1) * vel_valid[..., None]
            both = vel_valid[:, None, :] & vel_valid[:, :, None]
            values = (vel[:, None, :, :] - vel[:, :, None, :]) * both[..., None]

        rel = obs2[:, None, :, :] - obs2[:, :, None, :]  # rel[s, i, j] = pos_j - pos_i
        # a tensor divisor: PyTorch turns division by a Python scalar on the
        # card into a multiply by its reciprocal, which moves neighbours that
        # sit on a cell boundary into the next cell
        side = torch.tensor(self.cell_side, dtype=rel.dtype, device=rel.device)
        oij = rel / side + self.n / 2.0

        visible = present2[:, None, :] & present2[:, :, None]
        not_self = ~torch.eye(a, dtype=torch.bool, device=obs2.device)
        in_range = ((oij >= 0) & (oij < self.n)).all(dim=-1) & visible & not_self

        cell = torch.floor(oij).long()
        flat_cell = cell[..., 0] * self.n + cell[..., 1]
        write_cell = torch.where(in_range, flat_cell, 0)
        write_value = torch.where(in_range[..., None], values,
                                  torch.full_like(values, self.constant))
        grid = last_write_grid(write_cell, write_value, not_self, self.constant, g)
        return grid.reshape(s, a, self.n, self.n, -1).movedim(-1, 2)

    def apply(self, params: Dict, obs1, obs2, present1, present2) -> torch.Tensor:
        """Pooled interaction features ``[S, A, out_dim]``."""
        s, a = obs2.shape[:2]
        flat = self.make_grid(obs1, obs2, present1, present2).reshape(s, a, -1)
        return mlp(params["embedding"], flat)
