"""Interaction-module registry.

Port of ``trajnetplusplusbaselines_tpu/ops/pooling/__init__.py``, keyed by
the trainers' ``--type`` names: all eleven, with the same arguments and
defaults.  Every pool has ``init_params``, ``init_state``,
``apply(params, state, hidden, obs1, obs2, present1, present2, slot_mask)
-> (pooled [S, A, out_dim], state)``, ``out_dim``, ``stateful`` and
``reads_slot_mask``.

Which pool reaches a kernel on the card is ``models/lstm.LSTM.route``,
decided from the configuration before any launch: a directional grid of
side ``n * pool_size`` up to ``GRID_MAX_N`` gets its last-write grid from
the fused kernel's grid stage (the flagship D-LSTM, where autograd does not
record, its whole step from the fused kernel); every other pool is plain
PyTorch on either device.
"""

from .grid import GridBasedPooling
from .nongrid import (
    NMMP,
    AttentionMLPPooling,
    HiddenStateMLPPooling,
    NearestNeighborLSTM,
    NearestNeighborMLP,
    TrajectronPooling,
    rel_directional,
    rel_obs,
)

POOL_TYPES = (
    "vanilla",
    "occupancy",
    "directional",
    "social",
    "dir_social",
    "hiddenstatemlp",
    "attentionmlp",
    "nn",
    "nn_lstm",
    "traj_pool",
    "nmmp",
)


def make_pool(type_: str, args=None):
    """Build an interaction module from trainer-style args (None -> vanilla).

    args needs (with trainer defaults): hidden_dim, pool_dim, vel_dim,
    spatial_dim, attn_logit_cap, neigh, no_vel, cell_side, n, front,
    embedding_arch, pool_constant, norm, layer_dims, latent_dim, mp_iters.
    """
    if type_ == "vanilla":
        return None

    def get(name, default):
        return getattr(args, name, default) if args is not None else default

    hidden_dim = get("hidden_dim", 128)
    pool_dim = get("pool_dim", 256)

    if type_ == "hiddenstatemlp":
        return HiddenStateMLPPooling(hidden_dim=hidden_dim, out_dim=pool_dim,
                                     mlp_dim_vel=get("vel_dim", 32))
    if type_ == "attentionmlp":
        return AttentionMLPPooling(hidden_dim=hidden_dim, out_dim=pool_dim,
                                   mlp_dim_spatial=get("spatial_dim", 32),
                                   mlp_dim_vel=get("vel_dim", 32),
                                   logit_cap=get("attn_logit_cap", None))
    if type_ == "nn":
        return NearestNeighborMLP(n=get("neigh", 4), out_dim=pool_dim, no_vel=get("no_vel", False))
    if type_ == "nn_lstm":
        return NearestNeighborLSTM(n=get("neigh", 4), hidden_dim=hidden_dim, out_dim=pool_dim)
    if type_ == "traj_pool":
        return TrajectronPooling(hidden_dim=hidden_dim, out_dim=pool_dim)
    if type_ == "nmmp":
        return NMMP(hidden_dim=hidden_dim, out_dim=pool_dim, k=get("mp_iters", 5))
    if type_ in ("occupancy", "directional", "social", "dir_social"):
        return GridBasedPooling(
            type_=type_,
            hidden_dim=hidden_dim,
            cell_side=get("cell_side", 0.6),
            n=get("n", 12),
            front=get("front", False),
            out_dim=pool_dim,
            embedding_arch=get("embedding_arch", "one_layer"),
            constant=get("pool_constant", 0),
            norm=get("norm", 0),
            layer_dims=get("layer_dims", [512]),
            latent_dim=get("latent_dim", 16),
        )
    raise ValueError(f"unknown pool type {type_!r}")


__all__ = [
    "GridBasedPooling",
    "HiddenStateMLPPooling",
    "AttentionMLPPooling",
    "NearestNeighborMLP",
    "NearestNeighborLSTM",
    "TrajectronPooling",
    "NMMP",
    "POOL_TYPES",
    "make_pool",
    "rel_obs",
    "rel_directional",
]
