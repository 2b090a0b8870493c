"""Build and bind the CUDA kernels of csrc/ (B1 and B2 in
packed_kernels.cu, B4, B5 and B6 in hess_kernels.cu, both including the
shared per-element math of rows_point.cuh).

One `nvcc` call builds one shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, no torch.utils.cpp_extension):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/libbalm_kernels.so
         csrc/packed_kernels.cu csrc/hess_kernels.cu

nvcc contracts products and sums into FMAs as it likes; the one place
where that matters, the translation t = R b + t_w - c that cancels most
of its f32 bits on scenes hundreds of metres from the origin, rounds
each step explicitly in the source (`shifted_t`).
-Xptxas -v reports registers and spills into the build log.

The library goes to balm_tpu_torch/_build/ (ignored by git) and is
rebuilt only when the SHA-256 of the sources (every file of csrc/,
headers included) and flags changes (the hash
is stamped beside it).  The build writes a temporary file and renames it, so a
concurrent process never loads a half-written library.  A failed build
raises with nvcc's stderr.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "packed_kernels.cu", CSRC / "hess_kernels.cu")
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libbalm_kernels.so"
_STAMP = BUILD_DIR / "libbalm_kernels.sha256"
_LOG = BUILD_DIR / "libbalm_kernels.log"
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, the toolkit's default place, or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels are built on first use on the GPU")
    return found


FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v"]


def _source_hash() -> str:
    """SHA-256 of every source and header and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> dict:
    """Compile the kernels if the source changed; returns {'seconds',
    'rebuilt', 'log'} where log holds ptxas's register/spill report."""
    digest = _source_hash()
    if (not force and LIB_PATH.exists() and _STAMP.exists()
            and _STAMP.read_text().strip() == digest):
        log = _LOG.read_text() if _LOG.exists() else ""
        return {"seconds": 0.0, "rebuilt": False, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    _LOG.write_text(proc.stderr)
    _STAMP.write_text(digest)
    return {"seconds": seconds, "rebuilt": True, "log": proc.stderr}


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        h = ctypes.CDLL(str(LIB_PATH))
        vp, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        h.balm_csum_packed.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                       cint, vp]
        h.balm_csum_packed.restype = cint
        h.balm_rows_packed.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                       i64, i64, cint, vp]
        h.balm_rows_packed.restype = cint
        h.balm_rows_block_planes.argtypes = []
        h.balm_rows_block_planes.restype = cint
        h.balm_hess_v1_splits.argtypes = [i64, i64, cint]
        h.balm_hess_v1_splits.restype = cint
        h.balm_hess_v1.argtypes = [vp] * 9 + [i64, i64, i64, cint, vp]
        h.balm_hess_v1.restype = cint
        h.balm_hess_v2.argtypes = [vp] * 7 + [i64, i64, cint, vp]
        h.balm_hess_v2.restype = cint
        h.balm_hess_v3.argtypes = [vp] * 7 + [i64, i64, i64, cint, vp]
        h.balm_hess_v3.restype = cint
        h.balm_error_string.argtypes = [cint]
        h.balm_error_string.restype = ctypes.c_char_p
        _lib = h
        return _lib


def check_launch(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = lib().balm_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on t's device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
