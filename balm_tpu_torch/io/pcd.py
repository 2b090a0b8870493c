"""Minimal PCD v0.7 reader (binary and ascii), numpy-vectorized.

Counterpart: balm_tpu/io/pcd.py (read_pcd :18, read_pcd_xyz :66); it
replaces the reference's pcl::io::loadPCDFile
(src/benchmark/benchmark_realworld.cpp:89).  Only x, y and z are needed
by the BA pipeline; every declared field is parsed.  Host numpy: the
scans reach the device through the voxelizers.
"""

from __future__ import annotations

import numpy as np

_TYPEMAP = {("F", 4): "f4", ("F", 8): "f8",
            ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
            ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path):
    """Read a PCD file -> dict of field name -> (N,) numpy array."""
    with open(path, "rb") as fh:
        header = {}
        while True:
            line = fh.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        npoints = int(header["POINTS"][0])
        mode = header["DATA"][0]

        dt = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            base = _TYPEMAP[(typ, size)]
            dt.append((name, base) if cnt == 1 else (name, base, (cnt,)))
        dtype = np.dtype(dt)

        if mode == "binary":
            buf = fh.read(npoints * dtype.itemsize)
            arr = np.frombuffer(buf, dtype=dtype, count=npoints)
        elif mode == "ascii":
            raw = np.atleast_2d(np.loadtxt(fh, dtype=np.float64,
                                           max_rows=npoints))
            arr = np.zeros(npoints, dtype=dtype)
            col = 0
            for name, cnt in zip(fields, counts):
                if cnt == 1:
                    arr[name] = raw[:, col].astype(arr[name].dtype)
                else:
                    arr[name] = raw[:, col:col + cnt].astype(arr[name].dtype)
                col += cnt
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    return {name: np.ascontiguousarray(arr[name]) for name in fields}


def read_pcd_xyz(path, dtype=np.float64):
    """Read just the xyz coordinates -> (N, 3); non-finite points are
    dropped (lidar streams may carry them)."""
    d = read_pcd(path)
    pts = np.stack([d["x"], d["y"], d["z"]], axis=-1).astype(dtype)
    return pts[np.isfinite(pts).all(axis=1)]
