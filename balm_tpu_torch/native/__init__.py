"""Native (C++) host-side voxelizer, loaded via ctypes.

Counterpart: balm_tpu/native/__init__.py:28-70 (same C ABI, same engine
source, this package's own copy in voxelize_native.cpp).  Built on demand
with g++ into a shared library next to the source; the build writes a
temporary file and renames it, so concurrent first uses cannot load a
half-written library.  Falls back cleanly if no compiler exists —
callers must check `available()`.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "voxelize_native.cpp"
_LIB = _DIR / "libvoxelize_native.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            "-march=native", str(_SRC), "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not _LIB.exists()
                    or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
                _build()
            lib = ctypes.CDLL(str(_LIB))
        except (OSError, subprocess.CalledProcessError):
            return None
        fn = lib.voxelize_factors
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # world, body, scan
            ctypes.c_int64, ctypes.c_int64,                      # n, n_scans
            ctypes.c_double, ctypes.c_int64,                     # voxel, layer_limit
            ctypes.c_void_p, ctypes.c_int64,                     # ratios, n_ratio
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,      # min_points, min_observers, unit_coe
            ctypes.c_void_p,                                     # point_leaf
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # moments, coe, max_leaves
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # center, layer, decision
        ]
        fn2 = lib.prepare_points
        fn2.restype = None
        fn2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # scans, lens, n_scans
            ctypes.c_void_p, ctypes.c_void_p,                    # R, p
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # body, world, scan_id
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def prepare_points(scans, R, p):
    """Fused concat + per-scan rigid transform (parallel C++).

    scans: list of (Ni, 3) f64 body-frame clouds; R (W,3,3), p (W,3).
    Returns (body (N,3), world (N,3), scan_id (N,)).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native voxelizer unavailable (no g++?)")
    W = len(scans)
    scans = [np.ascontiguousarray(s, np.float64) for s in scans]
    lens = np.asarray([len(s) for s in scans], np.int64)
    ptrs = (ctypes.c_void_p * W)(*[s.ctypes.data for s in scans])
    R = np.ascontiguousarray(R, np.float64)
    p = np.ascontiguousarray(p, np.float64)
    N = int(lens.sum())
    body = np.empty((N, 3), np.float64)
    world = np.empty((N, 3), np.float64)
    scan_id = np.empty(N, np.int64)
    lib.prepare_points(
        ctypes.cast(ptrs, ctypes.c_void_p), lens.ctypes.data, W,
        R.ctypes.data, p.ctypes.data,
        body.ctypes.data, world.ctypes.data, scan_id.ctypes.data,
    )
    return body, world, scan_id


def voxelize_factors(world, body, scan_id, n_scans, voxel_size, layer_limit,
                     eigen_ratio, min_points, min_observers,
                     weighting="point_count", pad_to=128,
                     max_leaves=1 << 16):
    """Run the native adaptive voxelization, emitting factor tensors.

    Returns (n_leaves, point_leaf (N,), C (Gpad, W, 4, 4) f64,
    coe (Gpad,), leaf_center (Gpad, 3), leaf_layer (L,),
    leaf_decision (L,)) where Gpad = ceil(L / pad_to) * pad_to and rows
    [L:Gpad] are zero (padding planes contribute exactly zero).  The
    min_observers admission gate is applied inside the engine, so
    point_leaf ids are already compact over admitted leaves.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native voxelizer unavailable (no g++?)")
    world = np.ascontiguousarray(world, np.float64)
    body = np.ascontiguousarray(body, np.float64)
    scan_id = np.ascontiguousarray(scan_id, np.int64)
    ratios = np.ascontiguousarray(eigen_ratio, np.float64)
    n = len(world)
    unit = 1 if weighting == "unit" else 0

    while True:
        point_leaf = np.empty(n, np.int64)
        # empty, not zeros: the native side memsets only the rows it
        # emits; python zeroes just the [L:Gpad) padding slice below
        moments = np.empty((max_leaves, n_scans, 4, 4), np.float64)
        coe = np.empty(max_leaves, np.float64)
        center = np.empty((max_leaves, 3), np.float64)
        layer = np.empty(max_leaves, np.int64)
        decision = np.empty(max_leaves, np.float64)
        r = lib.voxelize_factors(
            world.ctypes.data, body.ctypes.data, scan_id.ctypes.data,
            n, n_scans, float(voxel_size), int(layer_limit),
            ratios.ctypes.data, len(ratios), int(min_points),
            int(min_observers), unit,
            point_leaf.ctypes.data,
            moments.ctypes.data, coe.ctypes.data, max_leaves,
            center.ctypes.data, layer.ctypes.data, decision.ctypes.data,
        )
        if r >= 0:
            L = int(r)
            break
        max_leaves = int(-r) + 1024  # retry with the required capacity

    Gpad = max(pad_to, -(-L // pad_to) * pad_to)
    if Gpad > max_leaves:   # rare: L lands within pad_to of capacity
        pad_m = np.zeros((Gpad - L, n_scans, 4, 4), np.float64)
        moments = np.concatenate([moments[:L], pad_m], axis=0)
        coe = np.concatenate([coe[:L], np.zeros(Gpad - L)])
        center = np.concatenate([center[:L], np.zeros((Gpad - L, 3))])
    else:
        moments[L:Gpad] = 0.0
        coe[L:Gpad] = 0.0
        center[L:Gpad] = 0.0
    return (L, point_leaf, moments[:Gpad], coe[:Gpad], center[:Gpad],
            layer[:L], decision[:L])
