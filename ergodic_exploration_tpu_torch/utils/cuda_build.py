"""Build a CUDA source file of this package into a shared library and load it.

Kernels are compiled on first use, by ``nvcc`` from the sources under
``ergodic_exploration_tpu_torch/csrc``, into ``build/kernels/`` at the root
of the checkout, or into the directory last given to :func:`set_build_dir`
(``Engine.warmup(..., persistent_cache=path)`` sets it). The library name
carries a hash of every source and header in ``csrc`` and of the flags, so
an edited source or flag builds anew and an unchanged one is loaded from
disk. The libraries have a plain C interface
and are loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). :func:`build_all` compiles several sources at once, one ``nvcc``
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple, Sequence

from ergodic_exploration_tpu_torch.utils.profiling import COUNTS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR  # where build() writes and looks for libraries


def set_build_dir(path=None) -> Path:
    """Build and load the libraries in ``path`` from now on (None: the
    default ``build/kernels/``); returns the directory. Libraries already
    loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = DEFAULT_BUILD_DIR if path is None else Path(path).resolve()
    return BUILD_DIR


# sm_90a: Hopper with its architecture-specific features. -fmad=false keeps
# every multiply and add rounded separately, as PyTorch's elementwise ops
# round them, so positions (and hence collision cells) agree bit for bit
# with the plain versions. No --use_fast_math: sinf/cosf/expf stay the
# accurate library versions PyTorch's own kernels use.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time (0.0 when loaded from an earlier build)
    log: str  # nvcc's output (register and shared-memory use per kernel)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str, source: str, flags: Sequence[str] = NVCC_FLAGS) -> Built:
    """Compile ``csrc/<source>`` into ``<BUILD_DIR>/<name>-<hash>.so``
    (unless that file exists) and load it (counted as ``libraries_loaded``,
    utils/profiling.py)."""
    COUNTS["libraries_loaded"] += 1
    h = hashlib.sha256("\0".join(flags).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags, "-o", tmp, str(CSRC / source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)


# library name -> source file of every kernel library of the package
LIBRARIES = {"solve_kernel": "solve_kernel.cu", "gmm_kernel": "gmm_kernel.cu",
             "mi_kernel": "mi_kernel.cu", "tick_glue": "tick_glue.cu",
             "reveal_kernel": "reveal_kernel.cu", "edt_kernel": "edt_kernel.cu",
             "mi_dense_kernel": "mi_dense_kernel.cu"}


def build_all() -> Dict[str, Built]:
    """Build every library of ``LIBRARIES``, all ``nvcc`` processes started
    together; returns name -> :class:`Built`."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        futures = {name: pool.submit(build, name, src) for name, src in LIBRARIES.items()}
        return {name: f.result() for name, f in futures.items()}
