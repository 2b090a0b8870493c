"""Build and bind the CUDA kernels of csrc/ (B1 and B2 in
packed_kernels.cu, single and batched launches, B4 and B6 in
hess_kernels.cu, B5 in hess_v3_kernels.cu, all three including the
shared per-element math of rows_point.cuh, the last two the Hopper
helpers of sm90.cuh, and B7 in moments_kernels.cu).

One `nvcc` process per source, all started together, compiles it to an
object; one more links them into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, no
torch.utils.cpp_extension):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <stem>.o csrc/<stem>.cu
         (for packed_kernels, hess_kernels, hess_v3_kernels and
          moments_kernels at once)
    nvcc -shared -o _build/libbalm_kernels.so *.o

nvcc contracts products and sums into FMAs as it likes; the one place
where that matters, the translation t = R b + t_w - c that cancels most
of its f32 bits on scenes hundreds of metres from the origin, rounds
each step explicitly in the source (`shifted_t`).
-Xptxas -v reports registers and spills into the build log.  The wall
time of the build is that of the slowest source, not their sum.

The library goes to balm_tpu_torch/_build/ (ignored by git) and is
rebuilt only when the SHA-256 of the sources (every file of csrc/,
headers included) and flags changes (the hash
is stamped beside it).  The build works in a temporary directory and
renames the library into place, so a concurrent process never loads a
half-written library.  A failed build
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
SOURCES = (CSRC / "packed_kernels.cu", CSRC / "hess_kernels.cu",
           CSRC / "hess_v3_kernels.cu", CSRC / "moments_kernels.cu")
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


# compile flags of each source (the link adds only -shared)
FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]


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
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:          # wait for every compile
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        so = os.path.join(tmpdir, LIB_PATH.name)
        cmd = [nvcc, "-shared", "-o", so, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(so, LIB_PATH)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    _LOG.write_text(log)
    _STAMP.write_text(digest)
    return {"seconds": seconds, "rebuilt": True, "log": log}


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
        h.balm_csum_packed_batched.argtypes = [vp] * 5 + [i64, i64, i64,
                                                         cint, vp]
        h.balm_csum_packed_batched.restype = cint
        h.balm_rows_packed_batched.argtypes = [vp] * 8 + [i64, i64, i64,
                                                         cint, vp]
        h.balm_rows_packed_batched.restype = cint
        h.balm_rows_block_planes.argtypes = []
        h.balm_rows_block_planes.restype = cint
        h.balm_hess_splits.argtypes = [i64, i64, cint]
        h.balm_hess_splits.restype = cint
        h.balm_hess_tile_floats.argtypes = [i64]
        h.balm_hess_tile_floats.restype = i64
        h.balm_hess_tri.argtypes = [vp] * 9 + [i64, i64, i64, cint, cint, vp]
        h.balm_hess_tri.restype = cint
        h.balm_hess_v3_plan.argtypes = [i64, i64, i64, cint, cint, vp]
        h.balm_hess_v3_plan.restype = cint
        h.balm_hess_v3_pieces.argtypes = [vp] * 6 + [i64, i64, i64, cint,
                                                     cint, vp]
        h.balm_hess_v3_pieces.restype = cint
        h.balm_hess_v3_pairs.argtypes = [vp] * 6 + [i64, i64, i64, cint,
                                                    i64, cint, vp]
        h.balm_hess_v3_pairs.restype = cint
        for name in ("balm_moments_f32", "balm_moments_f64"):
            fn = getattr(h, name)
            fn.argtypes = [vp] * 4 + [i64, i64, cint, vp]
            fn.restype = cint
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


def on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (a wrapper then runs its
    plain version); False when every one lies on one CUDA device (it
    launches its kernel); raises on anything else."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in ts]}")


def check(name, t, shape, dtype=torch.float32):
    """Raise unless t has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
