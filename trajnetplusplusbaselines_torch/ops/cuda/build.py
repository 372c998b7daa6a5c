"""Build and bind the package's CUDA kernels.

At first use, ``load_library()`` compiles every ``csrc/*.cu`` of the package
with ``nvcc``, one process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

then links the objects into one shared library with a plain C interface
(``nvcc -shared``) and loads it with ``ctypes``.  The library lands in
``build/torch_kernels/`` at the root of the checkout, named by a hash of the
sources, their headers (``csrc/*.cuh``) and the flags, so a changed source
rebuilds and an unchanged one loads what is there.  No fast-math flags: the
grid's cell indices rely on IEEE division.  A missing ``nvcc`` or a failed build raises;
nothing hands the work to the plain path.

Import this module only where a kernel is launched: the CPU tests import
every module of the package, and their machine has no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# seconds the build took in this process (0.0 when the library was already
# built); chip_smoke.py reports it
build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dlstm_directional_grid": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P],
    "dlstm_directional_grid_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _P],
    "dlstm_fused_step": [_P] * 17 + [_I, _I, _F, _F, _P],
    "dlstm_kernel_dims": [_P],
    "dlstm_train_in": [_P] * 12 + [_I] * 6 + [_P],
    "dlstm_train_cell": [_P] * 16 + [_I] * 6 + [_P],
    "dlstm_train_cell_backward": [_P] * 14 + [_I] * 4 + [_P],
    "dlstm_train_in_backward": [_P] * 2 + [_I] * 3 + [_P],
    "dlstm_train_loss": [_P] * 6 + [_I] * 5 + [_P],
    "dlstm_train_loss_backward": [_P] * 4 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _sources():
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtrajnet_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag, sources = _nvcc(), f"{os.getpid()}.tmp", _sources()
    objects = [lib.with_suffix(f".{src.stem}.{tag}.o") for src in sources]
    steps = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
             for src, obj in zip(sources, objects)]
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib.with_suffix(f".{tag}")),
            *map(str, objects)]
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    runs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(steps, procs)]
    if all(rc == 0 for _, _, rc in runs):
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs.append((link, proc.stdout, proc.returncode))
    build_seconds = time.perf_counter() - start
    lib.with_suffix(".log").write_text("".join(" ".join(cmd) + "\n" + out for cmd, out, _ in runs))
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(cmd, out, rc) for cmd, out, rc in runs if rc != 0]
    if failed:
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out[-4000:]}")
    os.replace(lib.with_suffix(f".{tag}"), lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def kernel_dims():
    """(n, embedding_dim, pool_dim, hidden_dim) the fused step was compiled
    for, the largest grid side the grid stage takes, and the packed
    weights' layout (blocks per cluster, warpgroups per block, K of a
    chunk)."""
    out = (ctypes.c_int * 8)()
    load_library().dlstm_kernel_dims(ctypes.cast(out, ctypes.c_void_p))
    return tuple(out)


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
