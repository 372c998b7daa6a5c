"""Sharded training and rollout steps.

Port of ``trajnetplusplusbaselines_tpu/parallel/train.py``: data
parallelism over the scene axis with tensor-parallel weight sharding
(``parallel/mesh.py``).  Where JAX jits one program and lets XLA insert the
reductions, each rank here runs its rows of the batch, the outputs are
gathered along the scene axis, the loss is the one-process loss of the
whole batch, and the gradients sum over ``data``.
"""

from typing import Callable, Optional

import torch

from ..ops.cuda import fused_train
from .mesh import (Mesh, batch_sharding, gather_params, param_shardings, replicated,
                   scene_sharding, shard_params, tree_map_with_path)
from .multihost import put_global


def _items(tree):
    """(path, leaf) of a params tree in the trainers' fixed order."""
    items = []
    tree_map_with_path(lambda path, leaf: items.append((path, leaf)), tree)
    return sorted(items, key=lambda item: item[0])


def make_sharded_train_step(model, optimizer: Callable, mesh: Optional[Mesh],
                            obs_length: int = 9, pred_length: int = 12, batch_size: int = 8):
    """A train step with scenes sharded over ``data`` and params over
    ``model``; ``mesh`` None is one process.

    ``optimizer(leaves)`` makes the optimizer (``trainers.common.make_optimizer``).
    Returns (step, place_batch, place_params):

    - ``place_params(params)``: this rank's blocks of the full params, leaves
      that autograd records;
    - ``place_batch(xy, mask, goals, slot_mask, scene_mask)``: the whole
      batch on this rank's device (the step runs the rank's rows of it and
      scores the whole);
    - ``step(params, opt, *batch) -> (params, opt, loss)``: one
      loss -> gradient -> update of the placed params in place, the loss
      ``fused_train.criterion_loss(...) * batch_size`` of the whole batch
      (``losses.prediction_loss``'s, on the gathered ``rel``); ``opt`` None
      makes the optimizer over the params' leaves.  Afterwards each leaf's
      ``grad`` is its gradient, summed over ``data``."""
    seq_length = obs_length + pred_length
    shardings = {}

    def rows(x, dim):
        return x if mesh is None else mesh.scene_rows(x, dim)

    def step(params, opt, xy, mask, goals, slot_mask, scene_mask):
        leaves = [leaf for _, leaf in _items(params)]
        if opt is None:
            opt = optimizer(leaves)
        full = params if mesh is None else gather_params(mesh, params, shardings)
        rel, _, _ = model.forward(
            full, rows(xy[:obs_length], 1), rows(mask[:obs_length], 1),
            prediction_truth=rows(xy[obs_length:seq_length - 1], 1),
            prediction_truth_mask=rows(mask[obs_length:seq_length - 1], 1),
            goals=rows(goals, 0), slot_mask=rows(slot_mask, 0))
        if mesh is not None:
            rel = mesh.gather_scenes(rel, 1)
        targets = xy[obs_length:seq_length, :, 0] - xy[obs_length - 1:seq_length - 1, :, 0]
        loss = fused_train.criterion_loss(rel, targets, scene_mask) * batch_size
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        if mesh is not None:
            grads = mesh.sum_over_data(grads)
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad
        opt.step()
        return params, opt, loss.detach()

    def place_batch(xy, mask, goals, slot_mask, scene_mask):
        if mesh is None:
            return tuple(torch.as_tensor(x) for x in (xy, mask, goals, slot_mask, scene_mask))
        whole = replicated(mesh)
        return tuple(put_global(whole, x) for x in (xy, mask, goals, slot_mask, scene_mask))

    def place_params(params):
        if mesh is not None:
            shardings.update(param_shardings(mesh, params))
            params = shard_params(mesh, params)
        return tree_map_with_path(lambda _, leaf: torch.as_tensor(leaf).detach().clone()
                                  .requires_grad_(), params)

    return step, place_batch, place_params


def make_sharded_rollout(model, mesh: Mesh, obs_length: int = 9, n_predict: int = 12):
    """Sharded autoregressive rollout over the scene axis (inference).

    Returns (rollout, place_batch): ``place_batch(xy, mask, goals,
    slot_mask)`` puts this rank's scenes of the global host arrays on its
    device; ``rollout(params, *placed)`` rolls them out and gathers every
    rank's, so each rank returns the global (rel_pred, pred, valid)."""

    def rollout(params, xy, mask, goals, slot_mask):
        with torch.no_grad():
            out = model.forward(params, xy[:obs_length], mask[:obs_length], goals=goals,
                                slot_mask=slot_mask, n_predict=n_predict)
            return tuple(mesh.gather_scenes(x, 1) for x in out)

    bsh, ssh = batch_sharding(mesh), scene_sharding(mesh)

    def place_batch(xy, mask, goals, slot_mask):
        return (put_global(bsh, xy), put_global(bsh, mask), put_global(ssh, goals),
                put_global(ssh, slot_mask))

    return rollout, place_batch
