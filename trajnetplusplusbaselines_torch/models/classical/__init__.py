"""The classical predictors: constant velocity, the Kalman filter, social
force and ORCA.  None is trained and none has weights.

Constant velocity, the Kalman filter and social force compute in PyTorch on
the device a caller names (``device``, default ``cuda``), folded over whole
datasets by their ``predict_dataset``; ORCA is a serial C++ simulator
stepped from Python on the host, as in the JAX package.
"""

import torch


def device_of(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device on a machine without
    one raises: no classical predictor carries on on the CPU instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not available")
    return device
