"""The native BC6H decoder: ``native/bc6h.cpp`` built with g++ at first use.

Counterpart of raytracedggx_tpu/io/native.py.  The source is the repo's
``native/bc6h.cpp``; the shared library goes to the port's build
directory (``raytracedggx_tpu_torch/build/``, next to the CUDA kernels'),
named by a hash of the source and flags, so an edited source builds anew
and ``native/librtggx_native.so`` is never written.  Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from ..ops.cuda_lib import BUILD_DIR, PKG

SOURCE = PKG.parent / "native" / "bc6h.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librtggx_bc6h_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The decoder library, built unless the one for this source exists."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True)
        os.replace(tmp, out)          # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(out))
    lib.bc6h_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.bc6h_decode.restype = None
    return lib


def bc6h_decode(blocks: np.ndarray, is_signed: bool = False) -> np.ndarray:
    """blocks: (N, 16) uint8 BC6H blocks -> (N, 16, 3) float32 texels
    (each block is a 4x4 tile, texels raster order)."""
    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, np.uint8).reshape(-1, 16)
    n = blocks.shape[0]
    out = np.empty((n, 16, 3), np.uint16)
    lib.bc6h_decode(blocks.ctypes.data, n, int(is_signed), out.ctypes.data)
    return out.view(np.float16).astype(np.float32)
