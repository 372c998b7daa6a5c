"""Interaction-module registry.

Port of ``trajnetplusplusbaselines_tpu/ops/pooling/__init__.py``, keyed by
the trainers' ``--type`` names.  ``vanilla``, ``occupancy`` and
``directional`` are ported; the other eight names raise, naming the ROADMAP
item that ports them.
"""

from .grid import GridBasedPooling

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

    args needs (with trainer defaults): hidden_dim, pool_dim, cell_side, n,
    front, embedding_arch, pool_constant, norm, layer_dims, latent_dim.
    """
    if type_ == "vanilla":
        return None

    def get(name, default):
        return getattr(args, name, default) if args is not None else default

    if type_ in ("occupancy", "directional"):
        return GridBasedPooling(
            type_=type_,
            hidden_dim=get("hidden_dim", 128),
            cell_side=get("cell_side", 0.6),
            n=get("n", 12),
            front=get("front", False),
            out_dim=get("pool_dim", 256),
            embedding_arch=get("embedding_arch", "one_layer"),
            constant=get("pool_constant", 0),
            norm=get("norm", 0),
            layer_dims=get("layer_dims", [512]),
            latent_dim=get("latent_dim", 16),
        )
    if type_ in ("social", "dir_social"):
        raise NotImplementedError(
            f"pool type {type_!r} is not ported yet (ROADMAP Queue 1 item 2)")
    if type_ in POOL_TYPES:
        raise NotImplementedError(
            f"pool type {type_!r} is not ported yet (ROADMAP Queue 1 item 3)")
    raise ValueError(f"unknown pool type {type_!r}")


__all__ = ["GridBasedPooling", "POOL_TYPES", "make_pool"]
