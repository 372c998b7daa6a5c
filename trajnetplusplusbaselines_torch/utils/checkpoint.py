"""Predictor pickles, read and written without jax.

The JAX package's ``save_predictor`` writes ``{"predictor_class", "model",
"params"}`` with the model's configuration object and numpy params
(``trajnetplusplusbaselines_tpu/utils/checkpoint.py``).  ``load_predictor``
reads that payload through an unpickler that maps the configuration classes
of either package to plain stubs (unpickling restores ``__dict__`` and
bypasses ``__init__``), then builds the port's model from the restored
attributes.  Any other class, predictor or configuration raises.
``save_predictor`` writes the same layout with the port's configuration.
"""

import pickle

from ..models.lstm import LSTM, LSTMPredictor
from ..ops.pooling.grid import GridBasedPooling
from .convert import params_from_jax, params_to_numpy


class _LSTMConfig:
    pass


class _GridConfig:
    pass


_CONFIG_CLASSES = {
    ("trajnetplusplusbaselines_tpu.models.lstm", "LSTM"): _LSTMConfig,
    ("trajnetplusplusbaselines_torch.models.lstm", "LSTM"): _LSTMConfig,
    ("trajnetplusplusbaselines_tpu.ops.pooling.grid", "GridBasedPooling"): _GridConfig,
    ("trajnetplusplusbaselines_torch.ops.pooling.grid", "GridBasedPooling"): _GridConfig,
}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CONFIG_CLASSES:
            return _CONFIG_CLASSES[(module, name)]
        if (module == "numpy" or module.startswith("numpy.")) and name in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"predictor pickle holds unsupported class {module}.{name}")


def _pool_from_config(cfg):
    if cfg is None:
        return None
    if not isinstance(cfg, _GridConfig):
        raise NotImplementedError(f"pool {type(cfg).__name__} is not ported yet")
    d = vars(cfg)
    # the constructor raises on every configuration that is not ported
    return GridBasedPooling(
        type_=d["type_"], hidden_dim=d["hidden_dim"], cell_side=d["cell_side"], n=d["n"],
        out_dim=d["out_dim"], pool_size=d["pool_size"], blur_size=d["blur_size"],
        front=d["front"], embedding_arch=d["embedding_arch"], constant=d["constant"],
        norm=d["norm"], layer_dims=d["layer_dims"], latent_dim=d["latent_dim"],
    )


def _model_from_config(cfg) -> LSTM:
    if not isinstance(cfg, _LSTMConfig):
        raise NotImplementedError(f"model {type(cfg).__name__} is not ported yet")
    d = vars(cfg)
    if d.get("compute_dtype") is not None:
        raise NotImplementedError(f"compute dtype {d['compute_dtype']} is not ported yet")
    return LSTM(
        embedding_dim=d["embedding_dim"], hidden_dim=d["hidden_dim"],
        pool=_pool_from_config(d["pool"]), pool_to_input=d["pool_to_input"],
        goal_dim=d["goal_dim"], goal_flag=d["goal_flag"],
    )


def load_predictor(filename: str) -> LSTMPredictor:
    """A predictor pickle of either package -> the port's ``LSTMPredictor``
    with params as CPU tensors in the pickle's dtype."""
    with open(filename, "rb") as f:
        payload = _Unpickler(f).load()
    if payload["predictor_class"] != "LSTMPredictor":
        raise NotImplementedError(f"{payload['predictor_class']} is not ported yet")
    return LSTMPredictor(_model_from_config(payload["model"]), params_from_jax(payload["params"]))


def save_predictor(predictor: LSTMPredictor, filename: str) -> None:
    payload = {
        "predictor_class": type(predictor).__name__,
        "model": predictor.model,
        "params": params_to_numpy(predictor.params),
    }
    with open(filename, "wb") as f:
        pickle.dump(payload, f)
