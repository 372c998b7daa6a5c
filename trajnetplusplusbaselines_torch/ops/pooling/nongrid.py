"""Non-grid interaction pooling modules.

Port of ``trajnetplusplusbaselines_tpu/ops/pooling/nongrid.py`` on dense
``[scene, agent, ...]`` batches, with the same masks:

- ``present1/present2 [S, A]``: agent observed at t-1 / t;
- ``slot_mask [S, A]``: the slot is a real track of the scene.  It is not
  ``present``: a padded slot's hidden state is 0, and its embedding is not
  the fill value, so the pools that read it (hidden-state MLP, attention,
  NMMP) need the caller's real one.

All pools return ``([S, A, out_dim], state)``; the step discards rows of
non-participating agents.  They are plain PyTorch on every device: the JAX
package has no Pallas kernel for them.
"""

import math
from typing import Dict, Tuple

import torch

from ..core import init_linear, init_lstm_cell, linear, lstm_cell


def rel_obs(obs: torch.Tensor) -> torch.Tensor:
    """rel[s, i, j] = obs[j] - obs[i]; pairwise relative positions."""
    return obs[:, None, :, :] - obs[:, :, None, :]


def rel_directional(obs1: torch.Tensor, obs2: torch.Tensor) -> torch.Tensor:
    """Pairwise relative velocities."""
    vel = obs2 - obs1
    return vel[:, None, :, :] - vel[:, :, None, :]


def _masked_fill(values: torch.Tensor, valid: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(valid[..., None], values, torch.full_like(values, fill))


def _lstm_state(num_scenes, num_agents, hidden_dim, device, dtype):
    shape = (num_scenes, num_agents, hidden_dim)
    return (torch.zeros(shape, device=device, dtype=dtype),
            torch.zeros(shape, device=device, dtype=dtype))


class HiddenStateMLPPooling:
    """S-GAN pooling: elementwise max over embedded neighbour attributes.

    Relative positions (fill -100 where either agent is unobserved), each
    slot's hidden state (fill -100 where the slot is padding) and x4 relative
    velocities (fill -100 unless both move), concatenated, max-pooled over
    the neighbours j (self included), then projected."""

    stateful = False
    reads_slot_mask = True

    def __init__(self, hidden_dim=128, mlp_dim=128, mlp_dim_spatial=32, mlp_dim_vel=32,
                 out_dim=None, fill_value=-100.0):
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.mlp_dim_spatial = mlp_dim_spatial
        self.mlp_dim_vel = mlp_dim_vel
        self.mlp_dim_hidden = mlp_dim - mlp_dim_spatial - mlp_dim_vel
        self.out_dim = out_dim or hidden_dim
        self.fill_value = fill_value

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params = {"spatial": init_linear(generator, 2, self.mlp_dim_spatial, **kw)}
        if self.mlp_dim_vel:
            params["vel"] = init_linear(generator, 2, self.mlp_dim_vel, **kw)
        if self.mlp_dim_hidden:
            params["hidden"] = init_linear(generator, self.hidden_dim, self.mlp_dim_hidden, **kw)
        params["out"] = init_linear(generator, self.mlp_dim, self.out_dim, **kw)
        return params

    def init_state(self, num_scenes, num_agents, device=None, dtype=torch.float32):
        return None

    def _embedded(self, params, hidden, obs1, obs2, present1, present2, slot_mask,
                  spatial_fill, hidden_fill, vel_fill):
        s, a = obs2.shape[:2]
        pos_valid = present2[:, None, :] & present2[:, :, None]  # [S, i, j]
        spatial = torch.relu(linear(params["spatial"], rel_obs(obs2 * present2[..., None])))
        parts = [_masked_fill(spatial, pos_valid, spatial_fill)]

        if self.mlp_dim_hidden:
            h_emb = torch.relu(linear(params["hidden"], hidden))
            h_emb = _masked_fill(h_emb, slot_mask, hidden_fill)  # [S, j, dh]
            parts.append(h_emb[:, None, :, :].expand(s, a, a, self.mlp_dim_hidden))

        if self.mlp_dim_vel:
            vel_ok = present1 & present2
            vel = (obs2 - obs1) * vel_ok[..., None]
            rv = vel[:, None, :, :] - vel[:, :, None, :]
            vel_valid = vel_ok[:, None, :] & vel_ok[:, :, None]
            vel_emb = torch.relu(linear(params["vel"], rv * 4.0))
            parts.append(_masked_fill(vel_emb, vel_valid, vel_fill))

        return torch.cat(parts, dim=-1)  # [S, i, j, mlp_dim]

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask):
        embedded = self._embedded(params, hidden, obs1, obs2, present1, present2, slot_mask,
                                  self.fill_value, self.fill_value, self.fill_value)
        pooled = embedded.amax(dim=2)  # over neighbours j, self included
        return linear(params["out"], pooled), state


class AttentionMLPPooling(HiddenStateMLPPooling):
    """S-BiGAT pooling: single-head attention over neighbour embeddings.

    The same embeddings with fills -10 / 0 / -10; agent i's own (diagonal)
    embedding is the query, every neighbour j (self included) a key and a
    value, through the extra q/k/v linears and MultiheadAttention's in and
    out projections.  ``logit_cap`` applies ``cap * tanh(logits / cap)``
    before the softmax (off by default)."""

    stateful = False
    reads_slot_mask = True

    def __init__(self, hidden_dim=128, mlp_dim=128, mlp_dim_spatial=32, mlp_dim_vel=32,
                 out_dim=None, fill_value=-10.0, logit_cap=None):
        super().__init__(hidden_dim, mlp_dim, mlp_dim_spatial, mlp_dim_vel, out_dim, fill_value)
        self.logit_cap = logit_cap

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        params = super().init_params(generator, **kw)
        e = self.mlp_dim
        for name in ("wq", "wk", "wv"):
            params[name] = init_linear(generator, e, e, bias=False, **kw)
        for name in ("in_q", "in_k", "in_v", "attn_out"):
            params[name] = init_linear(generator, e, e, **kw)
        return params

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask):
        embedded = self._embedded(params, hidden, obs1, obs2, present1, present2, slot_mask,
                                  self.fill_value, 0.0, self.fill_value)  # [S, i, j, E]
        diag = torch.diagonal(embedded, dim1=1, dim2=2).movedim(-1, 1)  # [S, A, E]
        q = linear(params["in_q"], linear(params["wq"], diag))
        k = linear(params["in_k"], linear(params["wk"], embedded))  # [S, A, A, E]
        v = linear(params["in_v"], linear(params["wv"], embedded))

        logits = torch.einsum("sie,sije->sij", q, k) * (1.0 / math.sqrt(self.mlp_dim))
        cap = getattr(self, "logit_cap", None)  # pickles from before the cap lack it
        if cap:
            logits = cap * torch.tanh(logits / cap)
        attn = torch.softmax(logits, dim=-1)
        ctx = linear(params["attn_out"], torch.einsum("sij,sije->sie", attn, v))
        return linear(params["out"], ctx), state


def _nearest_grid(obs1, obs2, present1, present2, n: int) -> torch.Tensor:
    """Top-n nearest neighbour attributes [S, A, n, 4] (rel pos ++ rel vel).

    Neighbours unobserved at t get the dummy distance 1000 and never the
    agent itself (1e9); rows at 1000 or more are zero, and scenes of fewer
    than n other agents are zero-padded.  The order of the n slots is part
    of the output: nearest first, ties to the lower index, as
    ``jax.lax.top_k`` orders them (a stable sort; ``torch.topk`` promises no
    order on ties)."""
    s, a = obs2.shape[:2]
    pos_valid = present2[:, None, :] & present2[:, :, None]
    rel_pos = rel_obs(obs2 * present2[..., None]) * pos_valid[..., None]

    vel_ok = present1 & present2
    vel = (obs2 - obs1) * vel_ok[..., None]
    vel_valid = vel_ok[:, None, :] & vel_ok[:, :, None]
    rel_vel = (vel[:, None, :, :] - vel[:, :, None, :]) * vel_valid[..., None]

    grid = torch.cat([rel_pos, rel_vel], dim=-1)  # [S, i, j, 4]

    dist = torch.sqrt((rel_pos * rel_pos).sum(dim=-1))
    dist = torch.where(pos_valid, dist, torch.full_like(dist, 1000.0))
    eye = torch.eye(a, dtype=torch.bool, device=obs2.device)
    dist = torch.where(eye, torch.full_like(dist, 1e9), dist)

    k = min(n, a)
    sel_dist, idx = torch.sort(dist, dim=-1, stable=True)
    sel_dist, idx = sel_dist[..., :k], idx[..., :k]  # [S, A, k]
    gathered = torch.gather(grid, 2, idx[..., None].expand(s, a, k, 4))
    gathered = torch.where(sel_dist[..., None] < 1000.0, gathered, torch.zeros_like(gathered))
    if k < n:  # zero-pad to n slots (tiny scenes)
        gathered = torch.cat([gathered, gathered.new_zeros((s, a, n - k, 4))], dim=2)
    return gathered


class NearestNeighborMLP:
    """Concatenated embeddings of the top-n nearest neighbours."""

    stateful = False
    reads_slot_mask = False

    def __init__(self, n=4, out_dim=32, no_vel=False):
        self.n = n
        self.out_dim = out_dim
        self.no_velocity = no_vel
        self.input_dim = 2 if no_vel else 4

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        return {"embedding": init_linear(generator, self.input_dim, self.out_dim // self.n,
                                         device=device, dtype=dtype)}

    def init_state(self, num_scenes, num_agents, device=None, dtype=torch.float32):
        return None

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask):
        s, a = obs2.shape[:2]
        nearest = _nearest_grid(obs1, obs2, present1, present2, self.n)
        if self.no_velocity:
            nearest = nearest[..., :2]
        emb = torch.relu(linear(params["embedding"], nearest))  # [S, A, n, out/n]
        return emb.reshape(s, a, -1), state


class NearestNeighborLSTM:
    """Top-n neighbour embedding fed through a per-agent interaction LSTM,
    updated for every track at every step."""

    stateful = True
    reads_slot_mask = False

    def __init__(self, n=4, hidden_dim=256, out_dim=32):
        self.n = n
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.input_dim = 4

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        return {
            "embedding": init_linear(generator, self.input_dim, self.out_dim // self.n, **kw),
            "pool_lstm": init_lstm_cell(generator, self.out_dim, self.hidden_dim, **kw),
            "hidden2pool": init_linear(generator, self.hidden_dim, self.out_dim, **kw),
        }

    def init_state(self, num_scenes, num_agents, device=None, dtype=torch.float32):
        return _lstm_state(num_scenes, num_agents, self.hidden_dim, device, dtype)

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask):
        s, a = obs2.shape[:2]
        nearest = _nearest_grid(obs1, obs2, present1, present2, self.n)
        emb = torch.relu(linear(params["embedding"], nearest)).reshape(s, a, -1)
        h_new, c_new = lstm_cell(params["pool_lstm"], emb, state)
        return linear(params["hidden2pool"], h_new), (h_new, c_new)


class TrajectronPooling:
    """Sum-pooled absolute states of the scene's other visible agents through
    an interaction LSTM (Trajectron), per scene."""

    stateful = True
    reads_slot_mask = False

    def __init__(self, n=4, hidden_dim=256, out_dim=32):
        self.n = n
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        return {
            "embedding": init_linear(generator, 8, self.out_dim, **kw),
            "pool_lstm": init_lstm_cell(generator, self.out_dim, self.hidden_dim, **kw),
            "hidden2pool": init_linear(generator, self.hidden_dim, self.out_dim, **kw),
        }

    def init_state(self, num_scenes, num_agents, device=None, dtype=torch.float32):
        return _lstm_state(num_scenes, num_agents, self.hidden_dim, device, dtype)

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask):
        vis = (present1 & present2)[..., None]  # states need both pos and vel
        vel = (obs2 - obs1) * vis
        pos = obs2 * vis
        states = torch.cat([pos, vel], dim=-1)  # [S, A, 4]
        total = (states * vis).sum(dim=1, keepdim=True)  # [S, 1, 4]
        others = (total - states) * vis
        emb = torch.relu(linear(params["embedding"], torch.cat([states, others], dim=-1)))
        emb = emb * vis  # invisible agents feed zeros
        h_new, c_new = lstm_cell(params["pool_lstm"], emb, state)
        return linear(params["hidden2pool"], h_new), (h_new, c_new)


class NMMP:
    """Neural message passing over agent hidden-state embeddings (NMMP).

    Per scene, k rounds of node -> edge -> node messages over the tracks
    taking part in the step (present at t-1 and t, real slots, self
    excluded).  The edge MLP is linear, so its masked mean over j decomposes
    into per-node products and one [A, A] x [A, m] contraction: no
    [S, A, A, 2m] tensor.  Scenes with <= 1 such track give zeros."""

    stateful = False
    reads_slot_mask = True

    def __init__(self, hidden_dim=128, mlp_dim=32, k=5, out_dim=None):
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.k = k
        self.out_dim = out_dim or hidden_dim

    def init_params(self, generator: torch.Generator, device=None, dtype=torch.float32) -> Dict:
        kw = dict(device=device, dtype=dtype)
        return {
            "hidden_embedding": init_linear(generator, self.hidden_dim, self.mlp_dim, **kw),
            "node_to_edge": init_linear(generator, 2 * self.mlp_dim, self.mlp_dim, **kw),
            "edge_to_node": init_linear(generator, 2 * self.mlp_dim, self.mlp_dim, **kw),
            "out": init_linear(generator, self.mlp_dim, self.out_dim, **kw),
        }

    def init_state(self, num_scenes, num_agents, device=None, dtype=torch.float32):
        return None

    def apply(self, params, state, hidden, obs1, obs2, present1, present2, slot_mask
              ) -> Tuple[torch.Tensor, object]:
        a = hidden.shape[1]
        node = torch.relu(linear(params["hidden_embedding"], hidden))  # [S, A, m]

        vis = present1 & present2 & slot_mask  # tracks taking part in the step
        eye = torch.eye(a, dtype=torch.bool, device=hidden.device)
        pair_valid = vis[:, None, :] & vis[:, :, None] & ~eye  # j != i
        count = pair_valid.sum(dim=2, keepdim=True)  # [S, A, 1]
        denom = count.clamp(min=1)

        w, bias = params["node_to_edge"]["w"], params["node_to_edge"]["b"]
        wa, wb = w[: self.mlp_dim], w[self.mlp_dim:]
        pv = pair_valid.to(node.dtype)  # [S, A, A]
        has_neigh = (count > 0).to(node.dtype)
        for _ in range(self.k):
            pa = node @ wa  # [S, A, m]
            pb = node @ wb
            neigh_pa = torch.einsum("sij,sjm->sim", pv, pa) / denom
            neigh_pb = torch.einsum("sij,sjm->sim", pv, pb) / denom
            e_out = (pa + bias) * has_neigh + neigh_pb
            e_in = (pb + bias) * has_neigh + neigh_pa
            node = linear(params["edge_to_node"], torch.cat([e_in, e_out], dim=-1))

        multi = vis.sum(dim=1, keepdim=True) > 1  # [S, 1]
        return linear(params["out"], node) * multi[..., None], state
