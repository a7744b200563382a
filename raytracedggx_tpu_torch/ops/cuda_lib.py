"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ctypes: at the
first launch of any kernel, nvcc compiles every source in ``csrc/`` for
``sm_90a`` (one nvcc process per source, all started together) and links
the objects into one shared library under ``raytracedggx_tpu_torch/build/``,
named by a hash of the sources and flags.  Importing this module builds and
loads nothing, so it imports on machines without nvcc.  No
``--use_fast_math``: padding triangles and empty 4-wide child slots rely
on NaN and infinity comparisons failing, and the filters' pow(x, 512)
must stay accurate.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v", "-c")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    # K1: nodes tris inv_mats attrs4 ray_o ray_d t_max t_min n_rays L stack
    # mode out_t out_u out_v out_n out_id out_inst stats stat_slots
    # stat_width stream
    "rtggx_trace_instanced": (_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                              _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # K1e: tris4 inv_mats ray_o ray_d slot inst n_rays out_u out_v stream
    "rtggx_slim_uv": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P),
    # K2: axis src normal rough depth gauss_table n_br out H W width br_max
    # stream
    "rtggx_reflection_pass": (_I, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F,
                              _F, _P),
    # K3: axis src normal metal depth out H W stream
    "rtggx_diffuse_pass": (_I, _P, _P, _P, _P, _P, _I, _I, _P),
    # K4: pairs tris4 inv ray_o ray_d t_max t_min n_rays stack
    # out_t out_u out_v out_pos stats stream
    "rtggx_trace_flat": (_P, _P, _P, _P, _P, _P, _F, _I, _I,
                         _P, _P, _P, _P, _P, _P),
    # K5: nodes tris4 inv ray_o ray_d t_max t_min n_rays stack
    # out_t out_u out_v out_pos stats stream
    "rtggx_trace_wide4": (_P, _P, _P, _P, _P, _P, _F, _I, _I,
                          _P, _P, _P, _P, _P, _P),
    # K6a/K6b: nodes smem_rows tris4 attrs boxes nq inv_mats pre ray_o ray_d
    # t_max t_min n_rays L stack flags npop threads
    # out_t out_u out_v out_n out_prim out_inst counts totals stream
    "rtggx_trace_lab": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _F, _I,
                        _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P),
    # K7: nodes rec inv_mats ray_o ray_d t_max t_min n_rays L stack threads
    # out_t out_u out_v out_slot out_inst totals stream
    "rtggx_trace_mxu": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P),
    # XF: table rows s_row s_k s_d inst inst_stride inst64 x x_row x_col
    # c d affine n out stream
    "rtggx_instance_xform": (_P, _I, _L, _L, _L, _P, _L, _I, _P, _L, _L,
                             _I, _I, _I, _I, _P, _P),
    # TS: cur c_y c_x c_c hist h_y h_x h_c hist16 vel v_y v_x v_c h w fw fh
    # row0 out stream
    "rtggx_temporal_ss": (_P, _L, _L, _L, _P, _L, _L, _L, _I, _P, _L, _L,
                          _L, _I, _I, _F, _F, _I, _P, _P),
    # BS: inv n_inv s0 s1 s2, wit n_wit s0 s1 s2, rm n_rm s0 s1, bc n_bc
    # s0 s1, sh s0 s1, tri tri_rows sizes offsets num_mips, o s0 s1, d s0
    # s1, t s, inst s inst64, hit s, nrm s0 s1, damp n out stream
    "rtggx_shade_bounce": (_P, _I, _L, _L, _L, _P, _I, _L, _L, _L,
                           _P, _I, _L, _L, _P, _I, _L, _L, _P, _L, _L,
                           _P, _L, _P, _P, _I, _P, _L, _L, _P, _L, _L,
                           _P, _L, _P, _L, _I, _P, _L, _P, _L, _L,
                           _I, _I, _P, _P),
    # stage mark (engine/spans.py): stage stream
    "rtggx_mark": (_I, _P),
    "rtggx_k1_max_stack": (),
    "rtggx_k4_max_stack": (),
    "rtggx_k5_max_stack": (),
    "rtggx_xform_max_rows": (),
    "rtggx_shade_max_rows": (),
    "rtggx_shade_max_mips": (),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # sources and headers
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
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    texts, failed = [], []
    for cmd, _, proc in jobs:         # wait for every compiler process
        text = proc.communicate()[0]
        texts.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    text = "".join(texts)
    log.write_text(text)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    return out, text, secs


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


def ptxas_reports(log: str) -> dict:
    """{mangled kernel name: (registers, stack frame bytes, spill store
    bytes, spill load bytes)} from the build's -Xptxas=-v log."""
    out, name, frame = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line:
            frame = [int(w) for w in line.replace(",", " ").split()
                     if w.isdigit()]
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            out[name] = (regs, *frame)
            name = None
    return out


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def pointer(t) -> int | None:
    """A tensor's device address, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def require(name, t, shape, dtype, device):
    """Raise unless t is a contiguous ``dtype`` tensor on ``device`` whose
    shape matches ``shape`` (None matches any extent)."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if len(shape) != t.dim() or any(s is not None and s != n
                                   for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: need shape {shape}, got "
                         f"{tuple(t.shape)}")
