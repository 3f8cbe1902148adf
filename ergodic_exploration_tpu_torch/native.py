"""ctypes bindings for the native host runtime (``native/runtime.cc``).

The port's own loader of the C++ library the JAX package ships: ROS int8 map
ingest, entropy maps and the exact EDT + gradient, run on the host at map
cadence (the single-robot node's map refresh). Same four functions and
semantics as ``ergodic_exploration_tpu/native.py``.

The library is compiled on first use with ``g++`` into ``build/native/`` at
the root of the checkout, under a name that carries a hash of the source and
the flags, so an edited source builds anew and the tree's ``native/`` is
never written. :func:`available` is False only when no ``g++`` exists; a
compile error is raised.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "runtime.cc"
BUILD_DIR = ROOT / "build" / "native"
# no -march=native: a library built on one host may be loaded on another
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

FAR = 1.0e6  # equal to ops/distance.py's FAR: "no obstacle anywhere"

_lock = threading.Lock()
_lib = None


def _gxx():
    return shutil.which("g++")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256("\0".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libeetruntime-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_gxx(), *FLAGS, "-o", tmp, str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _gxx() is None:
                raise RuntimeError("the native runtime needs g++, and none was found")
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            f32p = ctypes.POINTER(ctypes.c_float)
            i8p = ctypes.POINTER(ctypes.c_int8)
            lib.eet_ros_ingest.argtypes = [i8p, ctypes.c_int64, f32p]
            lib.eet_entropy.argtypes = [f32p, ctypes.c_int64, f32p]
            lib.eet_edt2d.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float, f32p, f32p]
            lib.eet_edt2d_batch.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                            ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                                            ctypes.c_float, f32p, f32p, ctypes.c_int32]
            for fn in (lib.eet_ros_ingest, lib.eet_entropy, lib.eet_edt2d,
                       lib.eet_edt2d_batch):
                fn.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """True where ``g++`` exists (the library is built on first use)."""
    return _gxx() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ros_ingest(raw: np.ndarray) -> np.ndarray:
    """int8 ROS occupancy data -> float data (-1 unknown, else 0..1)."""
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.int8)
    out = np.empty(raw.shape, dtype=np.float32)
    lib.eet_ros_ingest(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), raw.size, _fp(out))
    return out


def entropy_map(data: np.ndarray) -> np.ndarray:
    """Bernoulli entropy per cell (unknown -> H(0.5))."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float32)
    out = np.empty(data.shape, dtype=np.float32)
    lib.eet_entropy(_fp(data), data.size, _fp(out))
    return out


def edt2d(occ_prob: np.ndarray, occupied_threshold: float, resolution: float):
    """Exact EDT (meters) + gradient of one (H, W) map: (dist (H, W), grad
    (H, W, 2)) as ``DistanceField.from_grid`` defines them (FAR where no
    obstacle exists)."""
    lib = _load()
    occ = np.ascontiguousarray(occ_prob, dtype=np.float32)
    if occ.ndim != 2:
        raise ValueError(f"edt2d takes one (H, W) map, got shape {occ.shape}")
    h, w = occ.shape
    dist = np.empty((h, w), dtype=np.float32)
    grad = np.empty((h, w, 2), dtype=np.float32)
    lib.eet_edt2d(_fp(occ), h, w, occupied_threshold, resolution, FAR, _fp(dist), _fp(grad))
    return dist, grad


def edt2d_batch(occ_prob: np.ndarray, occupied_threshold: float, resolution: float,
                n_threads: int = 0):
    """Threaded exact EDT over (N, H, W) maps -> (dist (N, H, W), grad
    (N, H, W, 2)); ``n_threads`` 0 uses every hardware thread."""
    lib = _load()
    occ = np.ascontiguousarray(occ_prob, dtype=np.float32)
    if occ.ndim != 3:
        raise ValueError(f"edt2d_batch takes (N, H, W) maps, got shape {occ.shape}")
    n, h, w = occ.shape
    dist = np.empty((n, h, w), dtype=np.float32)
    grad = np.empty((n, h, w, 2), dtype=np.float32)
    lib.eet_edt2d_batch(_fp(occ), n, h, w, occupied_threshold, resolution, FAR, _fp(dist),
                        _fp(grad), n_threads)
    return dist, grad
