"""Build and load the port's CUDA kernels.

The kernels are CUDA C++ sources under `csrc/` with a plain C interface.
At first use they are compiled with `nvcc` for Hopper (`sm_90a`) into one
shared library under `build/torch_kernels/` at the repository root, named
by a hash of the sources, and loaded with `ctypes`. Nothing is built when
a module is imported: CPU-only machines import the whole package and never
reach this file's `lib()`.

One host routine, `csrc/witness_limbs.c` (a witness's Python ints to limbs,
through the Python C API), is compiled apart from the kernels with the host
C compiler against the running interpreter's headers, into
`libzkpoa_host_<digest>.so` in the same directory, and loaded with
`ctypes.PyDLL` (`host_lib()`); it builds and runs on CPU-only machines too.

Every launcher in the port counts its launches in `COUNTS` (a plain dict of
ints): a run can reset the counts, drive the main path and show which
kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import sysconfig
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

HOST_SOURCE = os.path.join(CSRC_DIR, "witness_limbs.c")
HOST_FLAGS = ["-O2", "-shared", "-fPIC"]

COUNTS: Dict[str, int] = {}

_LIB: Optional[ctypes.CDLL] = None
_HOST_LIB: Optional[ctypes.PyDLL] = None
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
    # msm_accum.cu: (group, xs, ys, valid, offset, n_rows, order, n, piece_start,
    # piece_end, n_pieces, K, sx, sy, sz, stream) and (group, ix, iy, iz, n_in,
    # group_start, group_end, n_groups, ox, oy, oz, stream)
    "zk_msm_accum": [_I, _P, _P, _P, _L, _L, _P, _L, _P, _P, _L, _I, _P, _P, _P, _P],
    "zk_msm_combine": [_I, _P, _P, _P, _L, _P, _P, _L, _P, _P, _P, _P],
    # msm_reduce.cu: (group, bx, by, bz, nw, nb, threads, ox, oy, oz, stream)
    "zk_msm_reduce": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    # msm_horner.cu: (group, tx, ty, tz, m, nw, c, n_signed, ox, oy, oz, stream)
    "zk_msm_horner": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # point_fold.cu: (group, ix, iy, iz, n_out, chunk, ox, oy, oz, stream)
    "zk_point_fold": [_I, _P, _P, _P, _L, _I, _P, _P, _P, _P],
    # field_ops.cu latency probe: (a, b, out, steps, stream)
    "zk_mont_chain": [_P, _P, _P, _L, _P],
    # ntt.cu: (in, out, twiddles, scale, log_n, s0, w, log_c, first, scale_mode, batch,
    # stride, stream)
    "zk_ntt_pass": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _P],
    # fixed_base.cu: (group, tx, ty, tvalid, scalars, nwin, n, ox, oy, oz, stream)
    "zk_fixed_base": [_I, _P, _P, _P, _P, _I, _L, _P, _P, _P, _P],
    # heavy_rounds.cu: (group, n_tables, tables, n_seg, segs, log_w, ox, oy, oz, stream),
    # tables and segs host int64 arrays
    "zk_heavy_rounds": [_I, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    # gather.cu: (tab, idx, T, W, M, out, stream)
    "zk_gather_rows": [_P, _P, _L, _I, _L, _P, _P],
    "zk_gather_vec": [_P, _P, _L, _I, _L, _P, _P],
    "zk_gather_async": [_P, _P, _L, _I, _L, _P, _P],
    # scalar_mul.cu: (group, px, py, pz, scalars, stride, n_bits, n, ox, oy, oz, stream) and
    # (group, x, y, z, digits, dstride, nd, log_half, n_bfly, stream)
    "zk_scalar_mul": [_I, _P, _P, _P, _P, _I, _I, _L, _P, _P, _P, _P],
    "zk_group_ntt_stage": [_I, _P, _P, _P, _P, _L, _I, _I, _L, _P],
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


def host_digest() -> str:
    h = hashlib.sha256()
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(sys.implementation.cache_tag.encode())
    return h.hexdigest()[:16]


def _cc() -> list:
    cc = shlex.split(sysconfig.get_config_var("CC") or "")
    return cc if cc and shutil.which(cc[0]) else ["cc"]


def build_host() -> str:
    """Compile `HOST_SOURCE` with the host C compiler into a shared library
    named by `host_digest()`; returns its path. Reuses a library built from
    the same source, flags and interpreter."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libzkpoa_host_{host_digest()}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [*_cc(), *HOST_FLAGS, "-I", sysconfig.get_paths()["include"], HOST_SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def host_lib() -> ctypes.PyDLL:
    """The loaded host routine library (built on first call). A `PyDLL`: its
    calls hold the interpreter lock and raise the Python error they set."""
    global _HOST_LIB
    if _HOST_LIB is None:
        handle = ctypes.PyDLL(build_host())
        fn = handle.zk_witness_limbs
        fn.argtypes = [ctypes.py_object, ctypes.c_ssize_t, _P, _P]
        fn.restype = ctypes.c_ssize_t
        _HOST_LIB = handle
    return _HOST_LIB


def launch(name: str, counter: Optional[str], *args) -> None:
    """Call one exported launcher on the current device's current stream,
    raise on a CUDA error, count the launch (under no counter when a
    wrapper's one kernel takes several launchers). It reads the stream's
    raw handle rather than building a `torch.cuda.current_stream()` object
    on every launch."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = getattr(lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    if counter is not None:
        COUNTS[counter] = COUNTS.get(counter, 0) + 1


def reset_counts() -> None:
    COUNTS.clear()
