"""Import the reference implementation (``trajnetbaselines``) on the port's
own stand-in for its ``trajnetplusplustools`` dependency.

The reference imports ``trajnetplusplustools``, which is not installed.
``load_reference`` registers a module of that name built from the port's
``data`` (``Reader``, ``TrackRow``, ``SceneRow``, ``writers``) and
``metrics.trajectory`` (``average_l2``, ``final_l2``, ``collision``,
``topk``, ``nll``), with empty ``show`` and ``interactions`` modules, and
placeholders for the simulators that the reference's classical predictors
import (``socialforce``, ``rvo2``, ``pykalman``: registered only where no
such module is loaded yet).  It then puts ``reference_root`` first on
``sys.path`` and imports ``trajnetbaselines`` from it.
"""

import os
import sys
import types

from .. import data
from ..metrics import trajectory


def _module(name: str, **attrs) -> types.ModuleType:
    module = types.ModuleType(name)
    for key, value in attrs.items():
        setattr(module, key, value)
    return module


def _install_stub() -> None:
    metrics = _module("trajnetplusplustools.metrics", average_l2=trajectory.average_l2,
                      final_l2=trajectory.final_l2, collision=trajectory.collision,
                      topk=trajectory.topk, nll=trajectory.nll)
    rows = _module("trajnetplusplustools.data", TrackRow=data.TrackRow, SceneRow=data.SceneRow)
    show = _module("trajnetplusplustools.show")  # plotting, never called
    interactions = _module("trajnetplusplustools.interactions")
    stub = _module("trajnetplusplustools", Reader=data.Reader, TrackRow=data.TrackRow,
                   SceneRow=data.SceneRow, writers=data.writers, metrics=metrics, data=rows,
                   show=show, interactions=interactions)
    for module in (stub, metrics, rows, show, interactions):
        sys.modules[module.__name__] = module

    # the simulators are called only by the classical predictors, never at
    # import time: placeholders let the reference's package import
    potentials = _module("socialforce.potentials", PedPedPotential=object)
    field_of_view = _module("socialforce.field_of_view", FieldOfView=object)
    socialforce = _module("socialforce", Simulator=object, potentials=potentials,
                          field_of_view=field_of_view)
    for module in (socialforce, potentials, field_of_view,
                   _module("rvo2", PyRVOSimulator=object),
                   _module("pykalman", KalmanFilter=object)):
        sys.modules.setdefault(module.__name__, module)


def load_reference(reference_root: str) -> types.ModuleType:
    """The ``trajnetbaselines`` package under ``reference_root``, imported
    on the stub (once: a package already imported is returned as it is).
    A ``reference_root`` without ``trajnetbaselines/`` raises
    ``FileNotFoundError`` naming the path."""
    if "trajnetbaselines" in sys.modules:
        return sys.modules["trajnetbaselines"]
    package = os.path.join(os.path.abspath(reference_root), "trajnetbaselines")
    if not os.path.isdir(package):
        raise FileNotFoundError(f"no reference implementation at {package}")
    _install_stub()
    sys.path.insert(0, os.path.dirname(package))
    import trajnetbaselines

    return trajnetbaselines
