"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ctypes: nvcc
compiles every source in ``csrc/`` for ``sm_90a`` into one shared library
under ``raytracedggx_tpu_torch/build/``, named by a hash of the sources
and flags, at the first launch of any kernel.  Importing this module
builds and loads nothing, so it imports on machines without nvcc.  No
``--use_fast_math``: padding triangles rely on NaN comparisons failing,
and the filters' pow(x, 512) must stay accurate.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # nodes tris inv_mats ray_o ray_d t_max t_min n_rays L stack
    # out_t out_u out_v out_slot out_inst stream
    "rtggx_trace_instanced": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P),
    # refl axis src normal aux depth out H W width br_max stream
    "rtggx_spatial_pass": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    "rtggx_k1_max_stack": (),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtggx_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def build() -> tuple[Path, str, float]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, compiler log, seconds spent compiling)."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out, res.stdout + res.stderr, secs


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use; every entry point has its
    argtypes set and returns an int (cudaGetLastError after launch)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream
