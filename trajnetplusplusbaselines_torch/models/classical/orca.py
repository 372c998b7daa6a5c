"""ORCA predictor: ctypes bindings over the repository's C++ simulator
(``native/orca.cpp``).

Port of ``trajnetplusplusbaselines_tpu/models/classical/orca.py``.  ORCA is
host code here, as it is in the JAX package: a serial C++ simulator stepped
from Python, agent by agent, 97 times a scene.  It has no device.

The library is compiled at first use with ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``build/torch_orca/`` at the root of the checkout, named by a
hash of the source and the flags, built under a unique temporary name and
moved into place with ``os.replace``, so that concurrent builds (parallel
test workers) never load a partial file.  Nothing is written under ``native/``.

Parameters follow the reference: a simulator of time step 1/fps,
neighbour distance, 10 neighbours at most, time horizon, radius and
maximum speed 1.5; agents join with maxSpeed = 1.3 x initial speed; the
preferred velocity steers toward the goal each substep, zero within
0.05 m.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List

import numpy as np

from .socialforce import MAX_SPEED_MULTIPLIER, initial_state

ROOT = Path(__file__).resolve().parents[3]
SOURCE = ROOT / "native" / "orca.cpp"
BUILD_DIR = ROOT / "build" / "torch_orca"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
DEST_TYPES = ("true", "interp", "pred_end")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liborca_{digest}.so"


def build() -> Path:
    """Compile ``native/orca.cpp`` unless a library of the same hash exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    tmp = Path(tmp)
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}\n{proc.stdout[-4000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f, p = ctypes.c_float, ctypes.c_void_p
    lib.orca_create.restype = p
    lib.orca_create.argtypes = [f, f, ctypes.c_int, f, f, f]
    lib.orca_destroy.restype = None
    lib.orca_destroy.argtypes = [p]
    lib.orca_add_agent.restype = ctypes.c_int
    lib.orca_add_agent.argtypes = [p] + [f] * 5
    lib.orca_set_pref_velocity.restype = None
    lib.orca_set_pref_velocity.argtypes = [p, ctypes.c_int, f, f]
    lib.orca_do_step.restype = None
    lib.orca_do_step.argtypes = [p]
    lib.orca_get_position.restype = None
    lib.orca_get_position.argtypes = [p, ctypes.c_int, ctypes.POINTER(f), ctypes.POINTER(f)]
    return lib


class OrcaSimulator:
    """Thin object wrapper over the C ABI (RVO2-like surface)."""

    def __init__(self, time_step, neighbor_dist=1.5, max_neighbors=10,
                 time_horizon=1.5, radius=0.4, max_speed=1.5):
        self._lib = load_library()
        self._sim = self._lib.orca_create(
            time_step, neighbor_dist, max_neighbors, time_horizon, radius, max_speed
        )

    def close(self) -> None:
        if self._sim:
            self._lib.orca_destroy(self._sim)
            self._sim = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_agent(self, position, velocity=(0.0, 0.0), max_speed=0.0) -> int:
        return self._lib.orca_add_agent(
            self._sim, position[0], position[1], velocity[0], velocity[1], max_speed
        )

    def set_agent_pref_velocity(self, i, velocity) -> None:
        self._lib.orca_set_pref_velocity(self._sim, i, velocity[0], velocity[1])

    def do_step(self) -> None:
        self._lib.orca_do_step(self._sim)

    def get_agent_position(self, i):
        x, y = ctypes.c_float(), ctypes.c_float()
        self._lib.orca_get_position(self._sim, i, ctypes.byref(x), ctypes.byref(y))
        return x.value, y.value


def predict(input_paths, dest_dict=None, dest_type="interp", orca_params=(1.5, 1.5, 0.4),
            predict_all=True, n_predict=12, obs_length=9):
    """Path-level API mirroring the JAX package's ``orca.predict``."""
    if dest_type not in DEST_TYPES:
        raise NotImplementedError(dest_type)
    state = initial_state(input_paths, dest_dict, dest_type, n_predict, obs_length)
    positions = [tuple(row[0:2]) for row in state]
    goals = [tuple(row[4:6]) for row in state]
    speeds = [float(row[6]) for row in state]

    sampling_rate = 20 / 2.5
    neighbor_dist, time_horizon, radius = orca_params
    with OrcaSimulator(1.0 / 20, neighbor_dist=neighbor_dist, max_neighbors=10,
                       time_horizon=time_horizon, radius=radius, max_speed=1.5) as sim:
        for row, speed in zip(state, speeds):
            sim.add_agent(tuple(row[0:2]), velocity=tuple(row[2:4]),
                          max_speed=MAX_SPEED_MULTIPLIER * speed)

        num_ped = len(speeds)
        trajectories = [[positions[i]] for i in range(num_ped)]
        count = 0
        end_range = 0.05
        while count < sampling_rate * n_predict + 1:
            count += 1
            sim.do_step()
            for i in range(num_ped):
                if count == 1:
                    trajectories[i].pop(0)
                position = sim.get_agent_position(i)
                if count % sampling_rate == 0:
                    trajectories[i].append(position)

                # steer toward the goal; stop within end_range
                to_goal = np.array(goals[i]) - np.array(position)
                dist = np.linalg.norm(to_goal)
                if dist < end_range:
                    sim.set_agent_pref_velocity(i, (0.0, 0.0))
                else:
                    pref = speeds[i] * to_goal / dist if dist > speeds[i] else to_goal
                    sim.set_agent_pref_velocity(i, tuple(pref.tolist()))

    states = np.array(trajectories).transpose(1, 0, 2)
    return {0: (states[:, 0, 0:2], states[:, 1:, 0:2] if predict_all else [])}


def predict_dataset(scenes: List[list], dest_dict=None, dest_type="interp",
                    orca_params=(1.5, 1.5, 0.4), predict_all=True, n_predict=12,
                    obs_length=9) -> List[dict]:
    """``predict`` of every scene, one after the other, on the host."""
    return [predict(paths, dest_dict, dest_type, orca_params, predict_all, n_predict, obs_length)
            for paths in scenes]
