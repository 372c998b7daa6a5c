"""Parameter primitives: linear layers, MLPs and the LSTM cell.

Port of ``trajnetplusplusbaselines_tpu/ops/core.py``.  Parameters are nested
dicts of tensors in the JAX layout (``w`` stored ``[in, out]``, LSTM gates in
the order i, f, g, o with separate ``b_ih`` / ``b_hh``), so a JAX checkpoint
converts leaf by leaf (``utils/convert.py``).  Initialisation draws from a
``torch.Generator`` with the same uniform +-1/sqrt(fan_in) bounds as the JAX
package; the numbers differ from JAX's for the same seed.

Everything is shape-polymorphic over leading batch dims: inputs are
``[..., features]``.
"""

import math
from typing import Dict, List, Sequence, Tuple

import torch


def _uniform(generator: torch.Generator, shape, bound: float, device, dtype):
    # drawn on the CPU so a seed gives the same weights on every device
    x = torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=generator)
    return x.to(device)


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, device=None, dtype=torch.float32) -> Dict:
    k = 1.0 / math.sqrt(in_dim)
    params = {"w": _uniform(generator, (in_dim, out_dim), k, device, dtype)}
    if bias:
        params["b"] = _uniform(generator, (out_dim,), k, device, dtype)
    return params


def linear(params: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def init_mlp(generator: torch.Generator, dims: Sequence[int], device=None,
             dtype=torch.float32) -> List[Dict]:
    """Linear+ReLU stack."""
    return [init_linear(generator, i, o, device=device, dtype=dtype)
            for i, o in zip(dims[:-1], dims[1:])]


def mlp(params: List[Dict], x: torch.Tensor, final_relu: bool = True) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = linear(layer, x)
        if final_relu or i < len(params) - 1:
            x = torch.relu(x)
    return x


def init_lstm_cell(generator: torch.Generator, in_dim: int, hidden_dim: int,
                   device=None, dtype=torch.float32) -> Dict:
    """LSTM cell parameters, gate order (i, f, g, o)."""
    k = 1.0 / math.sqrt(hidden_dim)
    return {
        "w_ih": _uniform(generator, (in_dim, 4 * hidden_dim), k, device, dtype),
        "w_hh": _uniform(generator, (hidden_dim, 4 * hidden_dim), k, device, dtype),
        "b_ih": _uniform(generator, (4 * hidden_dim,), k, device, dtype),
        "b_hh": _uniform(generator, (4 * hidden_dim,), k, device, dtype),
    }


def lstm_pointwise(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM's elementwise stage on pre-activations ``[..., 4H]``."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(params: Dict, x: torch.Tensor, hc: Tuple[torch.Tensor, torch.Tensor]):
    """One LSTM cell step over ``[..., features]`` inputs."""
    h, c = hc
    gates = x @ params["w_ih"] + h @ params["w_hh"] + (params["b_ih"] + params["b_hh"])
    return lstm_pointwise(gates, c)
