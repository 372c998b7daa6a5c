"""Predictor pickles and training-state sidecars, read and written without jax.

The JAX package's ``save_predictor`` writes ``{"predictor_class", "model",
"params"}`` with the model's configuration object and numpy params
(``trajnetplusplusbaselines_tpu/utils/checkpoint.py``), and beside it the
sidecar ``<out>.state``: ``{epoch, params, opt_state_hyper, opt_state}`` (an
SGAN's has ``g_opt_state`` and ``d_opt_state``).  ``load_predictor`` reads
the predictor through an unpickler that maps the configuration classes of
either package (the LSTM, the SGAN with its generator and discriminator,
the VAE and every pool class) to plain stubs (unpickling restores
``__dict__`` and bypasses ``__init__``), then builds the port's model from
the restored attributes.  A configuration's compute dtype (JAX's
``jnp.bfloat16``, pickled by reference, the name ``"bfloat16"`` or
``torch.bfloat16``) becomes the model's ``with_dtype(torch.bfloat16)``, and
the predictor serves in bf16; another compute dtype raises
``NotImplementedError``, any other class ``UnpicklingError``.
``save_predictor`` writes the same layout with the port's configuration,
and the sidecar when given a state.

The port's sidecar holds numpy only; its optimizer state is the torch Adam
state keyed by parameter path (``trainers/common.adam_state_to_numpy``).  A
JAX sidecar's ``opt_state`` is optax's state, a tree of NamedTuples:
``load_state`` maps their classes to a tuple stub, with no optax import, so
the weights of either package's sidecar load, and
``adam_state_from_optax`` turns its Adam moments into the port's state, so
``--load-full-state`` resumes a JAX run.
"""

import inspect
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.lstm import LSTM, LSTMPredictor
from ..models.sgan import SGAN, LSTMDiscriminator, LSTMGenerator, SGANPredictor
from ..models.vae import VAE, VAEPredictor
from ..ops import pooling
from ..trainers.common import param_items
from .convert import params_from_jax, params_to_numpy


def _stub(port_class):
    """A stub class for the pickled configuration of one port class."""
    return type(f"_{port_class.__name__}Config", (), {"port_class": port_class})


_CLASSES = {
    "models.lstm": (LSTM,),
    "models.sgan": (SGAN, LSTMGenerator, LSTMDiscriminator),
    "models.vae": (VAE,),
    "ops.pooling.grid": (pooling.GridBasedPooling,),
    "ops.pooling.nongrid": (pooling.HiddenStateMLPPooling, pooling.AttentionMLPPooling,
                            pooling.NearestNeighborMLP, pooling.NearestNeighborLSTM,
                            pooling.TrajectronPooling, pooling.NMMP),
}
_CONFIG_CLASSES = {
    (f"{package}.{module}", cls.__name__): _stub(cls)
    for package in ("trajnetplusplusbaselines_tpu", "trajnetplusplusbaselines_torch")
    for module, classes in _CLASSES.items() for cls in classes
}
_PREDICTORS = {"LSTMPredictor": (LSTMPredictor, LSTM), "SGANPredictor": (SGANPredictor, SGAN),
               "VAEPredictor": (VAEPredictor, VAE)}
# constructor argument -> the attribute the configuration keeps it under,
# where the two differ
_ATTRIBUTE_OF = {"no_vel": "no_velocity"}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
# a configuration's compute dtype, pickled by reference
_DTYPES = {("jax.numpy", "bfloat16"): torch.bfloat16, ("torch", "bfloat16"): torch.bfloat16}


class OptaxState(tuple):
    """Stands in for an optax state NamedTuple of a JAX sidecar: its fields,
    in order, as a tuple."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CONFIG_CLASSES:
            return _CONFIG_CLASSES[(module, name)]
        if (module, name) in _DTYPES:
            return _DTYPES[(module, name)]
        if (module == "numpy" or module.startswith("numpy.")) and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"pickle holds unsupported class {module}.{name}")


class _StateUnpickler(_Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            return OptaxState
        return super().find_class(module, name)


def from_attributes(port_class, attrs: dict):
    """An object of ``port_class`` (a model or a pool) from the attributes of
    a configuration of either package: its constructor's arguments read
    from them.  An attribute that an older pickle lacks takes the
    constructor's default (``logit_cap``); attributes that are not arguments
    (the JAX grid's ``scatter_impl``) are dropped."""
    kwargs = {}
    for name, param in inspect.signature(port_class).parameters.items():
        attr = _ATTRIBUTE_OF.get(name, name)
        if attr in attrs:
            kwargs[name] = attrs[attr]
        elif param.default is inspect.Parameter.empty:
            raise ValueError(f"{port_class.__name__} configuration has no {attr!r}")
    return port_class(**kwargs)


def compute_dtype(value) -> Optional[torch.dtype]:
    """The torch dtype of a configuration's restored ``compute_dtype``: None,
    or bf16 however it was pickled; another dtype raises."""
    if value is None:
        return None
    if value is torch.bfloat16 or value == "bfloat16":
        return torch.bfloat16
    raise NotImplementedError(f"compute dtype {value!r} is not ported: only bfloat16")


def _from_config(cfg):
    """The port's object for a restored configuration stub, its nested
    configurations (a model's pool, an SGAN's generator and discriminator)
    built first."""
    if cfg is None:
        return None
    port_class = getattr(type(cfg), "port_class", None)
    if port_class is None:
        raise NotImplementedError(f"{type(cfg).__name__} is not ported yet")
    attrs = dict(vars(cfg))
    dtype = compute_dtype(attrs.get("compute_dtype"))
    for key in ("pool", "generator", "discriminator"):
        if key in attrs:
            attrs[key] = _from_config(attrs[key])
    obj = from_attributes(port_class, attrs)
    if dtype is not None:
        obj.with_dtype(dtype)
    return obj


def load_predictor(filename: str):
    """A predictor pickle of either package -> the port's ``LSTMPredictor``,
    ``SGANPredictor`` or ``VAEPredictor``, with params as CPU tensors in the
    pickle's dtype."""
    with open(filename, "rb") as f:
        payload = _Unpickler(f).load()
    if payload["predictor_class"] not in _PREDICTORS:
        raise NotImplementedError(f"{payload['predictor_class']} is not ported yet")
    predictor_class, model_class = _PREDICTORS[payload["predictor_class"]]
    model = _from_config(payload["model"])
    if type(model) is not model_class:
        raise ValueError(f"{predictor_class.__name__} pickle holds a {type(model).__name__}")
    return predictor_class(model, params_from_jax(payload["params"]))


def save_predictor(predictor, filename: str, state=None) -> None:
    """Write the predictor pickle and, given a training ``state`` (numpy
    leaves), its sidecar ``filename + ".state"``."""
    payload = {
        "predictor_class": type(predictor).__name__,
        "model": predictor.model,
        "params": params_to_numpy(predictor.params),
    }
    with open(filename, "wb") as f:
        pickle.dump(payload, f)
    if state is not None:
        with open(filename + ".state", "wb") as f:
            pickle.dump(state, f)


def load_state(filename: str) -> dict:
    """A training-state sidecar of either package: ``{epoch, params,
    opt_state_hyper, opt_state}`` with numpy params.  A JAX sidecar's
    ``opt_state`` comes back as ``OptaxState`` tuples."""
    with open(filename, "rb") as f:
        return _StateUnpickler(f).load()


def is_port_opt_state(opt_state) -> bool:
    """True for the port's Adam state (a dict by parameter path), False for
    a JAX sidecar's optax state."""
    return isinstance(opt_state, dict)


def _adam_moments(state):
    """optax's ``ScaleByAdamState(count, mu, nu)`` in a restored optax state:
    found by its shape (a count and two trees of the same structure), not by
    its index in the chain, which moves with ``--clip_grad``."""
    if isinstance(state, OptaxState) and len(state) == 3 and all(
            isinstance(x, dict) for x in state[1:]):
        mu, nu = (dict(param_items(x)) for x in state[1:])
        if mu.keys() == nu.keys() and np.ndim(state[0]) == 0:
            return state
    if isinstance(state, tuple):
        found = [m for m in map(_adam_moments, state) if m is not None]
        if len(found) > 1:
            raise ValueError("the optax state holds more than one Adam state")
        return found[0] if found else None
    return None


def adam_state_from_optax(opt_state) -> dict:
    """The port's Adam state (``trainers/common.adam_state_to_numpy``'s
    layout) from a JAX sidecar's optax state: ``inject_hyperparams`` around
    the chain of ``trainers/common.make_optimizer`` (an optional clip,
    ``add_decayed_weights``, ``scale_by_adam``, ``scale_by_learning_rate``).
    ``mu`` is ``exp_avg``, ``nu`` ``exp_avg_sq`` and ``count`` ``step``, by
    parameter path."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("the optax state holds no Adam state (ScaleByAdamState)")
    count, mu, nu = adam
    step = float(np.asarray(count))
    nu = dict(param_items(nu))
    return {path: {"step": step, "exp_avg": np.asarray(m), "exp_avg_sq": np.asarray(nu[path])}
            for path, m in param_items(mu)}


def merge_params_nonstrict(init_params, loaded_params) -> Tuple[Any, list]:
    """Copy loaded leaves whose path and shape match into ``init_params``
    (as tensors of the init leaf's dtype and device); report the rest."""
    skipped = []

    def merge(path, init_leaf):
        node = loaded_params
        for p in path:
            if isinstance(node, dict) and p in node:
                node = node[p]
            elif isinstance(node, (list, tuple)) and isinstance(p, int) and p < len(node):
                node = node[p]
            else:
                skipped.append("/".join(map(str, path)))
                return init_leaf
        if hasattr(node, "shape") and tuple(node.shape) == tuple(init_leaf.shape):
            return torch.tensor(np.asarray(node), dtype=init_leaf.dtype, device=init_leaf.device)
        skipped.append("/".join(map(str, path)))
        return init_leaf

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (i,), v) for i, v in enumerate(node))
        return merge(path, node)

    return walk((), init_params), skipped
