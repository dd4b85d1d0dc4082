"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ sources under `csrc/` with a plain C interface.
At first use they are compiled with `nvcc` for Hopper (`sm_90a`) into one
shared library under `build/torch_kernels/` at the repository root, named
by a hash of the sources, and loaded with `ctypes`. Nothing is built when
a module is imported: CPU-only machines import the whole package and never
reach this file's `lib()`.

Every launcher in the port counts its launches in `COUNTS` (a plain dict of
ints): a run can reset the counts, drive the main path and show which
kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
REPO_ROOT = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

COUNTS: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C signatures of every exported launcher (all return a cudaError_t as int)
SIGNATURES = {
    # field_ops.cu
    "zk_field_binop": [_I, _I, _P, _P, _P, _L, _L, _P],
    # point_ops.cu: (group, x1, y1, z1, x2, y2, z2/valid, ox, oy, oz, n, stream)
    "zk_point_add": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
    "zk_point_add_affine": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
    "zk_point_double": [_I, _P, _P, _P, _P, _P, _P, _L, _P],
    # msm_accum.cu
    "zk_msm_accum": [_I, _P, _P, _P, _L, _L, _P, _P, _I, _I, _L, _P, _P, _P, _P],
    # msm_reduce.cu
    "zk_msm_reduce": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # fixed_base.cu: (group, tx, ty, tvalid, scalars, nwin, n, ox, oy, oz, stream)
    "zk_fixed_base": [_I, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P],
    # gather.cu: (tab, idx, T, W, M, out, stream)
    "zk_gather_smem_rows": [_P, _P, _L, _I, _L, _P, _P],
    "zk_gather_smem_vec": [_P, _P, _L, _I, _L, _P, _P],
    "zk_gather_async": [_P, _P, _L, _I, _L, _P, _P],
}


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu (one nvcc process per file, in parallel) and link
    them into one shared library; returns its path. Reuses a library built
    from the same sources."""
    digest = source_digest()
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libzkpoa_kernels_{digest}.so")
    log_path = os.path.join(BUILD_DIR, f"ptxas_{digest}.log")
    if os.path.exists(so_path):
        BUILD_INFO.update(path=so_path, seconds=0.0, cached=True, log=log_path)
        return so_path
    nvcc = _nvcc()
    cu_files = [p for p in _sources() if p.endswith(".cu")]
    t0 = time.time()

    def compile_one(src):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{digest}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        return obj, proc.stderr

    with ThreadPoolExecutor(max_workers=len(cu_files)) as ex:
        results = list(ex.map(compile_one, cu_files))
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [nvcc, "-shared", "-o", tmp, *[obj for obj, _ in results]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{proc.stdout}\n{proc.stderr}")
    with open(log_path, "w") as f:
        for (_obj, log), src in zip(results, cu_files):
            f.write(f"== {os.path.basename(src)}\n{log}\n")
    os.replace(tmp, so_path)
    for obj, _log in results:
        os.remove(obj)
    BUILD_INFO.update(path=so_path, seconds=time.time() - t0, cached=False, log=log_path)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def launch(name: str, counter: str, *args) -> None:
    """Call one exported launcher, raise on a CUDA error, count the launch."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    COUNTS[counter] = COUNTS.get(counter, 0) + 1


def reset_counts() -> None:
    COUNTS.clear()
