"""LOAM-style curvature feature extraction (surf / edge split).

Counterpart: balm_tpu/features/loam.py (LoamConfig :26, curvature :38,
extract :55), copied: host numpy, no tensors.

Re-design of the reference's velodyne feature extractor
(BALM-old/src/features/velodyne_feature.cpp:1-516): per scan line, local
curvature over a +-`half_k` neighborhood classifies points into SURF (low
curvature, feeds plane factors) and EDGE (high curvature, feeds line
factors, the l_set=(0,1) cost).  Vectorized numpy, per-sector top-k
selection like the reference's 6-sector split.

The rule-based Livox extractor (BALM-old/src/features/livox_feature.cpp)
with its per-model jump/blind heuristics is intentionally not ported;
curvature extraction covers the same role for mechanically spinning
lidars, and dense adaptive voxelization (voxel/grid.py) subsumes feature
extraction entirely for the BALM-2.0-style pipelines.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class LoamConfig:
    half_k: int = 5             # neighborhood half width
    blind: float = 0.5          # min range [m]
    # thresholds on the range-normalized curvature; scale with angular
    # resolution (these suit ~0.35 deg/step spinning lidars)
    edge_thresh: float = 1e-4   # curvature above -> edge candidate
    surf_thresh: float = 1e-5   # curvature below -> surf candidate
    sectors: int = 6
    max_edge_per_sector: int = 20
    surf_stride: int = 2        # keep every k-th surf point


def curvature(line: np.ndarray, half_k: int = 5) -> np.ndarray:
    """c_i = || sum_{j in +-k} (p_j - p_i) ||^2 / (2k |p_i|)^2
    (velodyne_feature.cpp's curvature, normalized by range)."""
    n = len(line)
    if n < 2 * half_k + 1:
        return np.full(n, np.inf)
    csum = np.cumsum(np.concatenate([np.zeros((1, 3)), line]), axis=0)
    k2 = 2 * half_k
    window = csum[k2 + 1:] - csum[:-(k2 + 1)]        # sums of 2k+1 points
    diff = window - (k2 + 1) * line[half_k:n - half_k]
    rng = np.linalg.norm(line[half_k:n - half_k], axis=-1)
    c = np.sum(diff * diff, axis=-1) / np.maximum((k2 * rng) ** 2, 1e-12)
    out = np.full(n, np.inf)
    out[half_k:n - half_k] = c
    return out


def extract(lines: List[np.ndarray], cfg: LoamConfig = LoamConfig()
            ) -> Tuple[np.ndarray, np.ndarray]:
    """lines: list of (Ni, 3) ordered scan lines (rings).
    Returns (surf_points (S,3), edge_points (E,3))."""
    surfs, edges = [], []
    for line in lines:
        if len(line) == 0:
            continue
        rng = np.linalg.norm(line, axis=-1)
        ok = rng > cfg.blind
        c = curvature(line, cfg.half_k)
        n = len(line)
        bounds = np.linspace(0, n, cfg.sectors + 1).astype(int)
        for s in range(cfg.sectors):
            lo, hi = bounds[s], bounds[s + 1]
            idx = np.arange(lo, hi)
            idx = idx[ok[idx] & np.isfinite(c[idx])]
            if len(idx) == 0:
                continue
            ci = c[idx]
            edge_sel = idx[ci > cfg.edge_thresh]
            if len(edge_sel) > cfg.max_edge_per_sector:
                order = np.argsort(-c[edge_sel])
                edge_sel = edge_sel[order[: cfg.max_edge_per_sector]]
            surf_sel = idx[ci < cfg.surf_thresh][:: cfg.surf_stride]
            edges.append(line[edge_sel])
            surfs.append(line[surf_sel])
    surf = np.concatenate(surfs) if surfs else np.zeros((0, 3))
    edge = np.concatenate(edges) if edges else np.zeros((0, 3))
    return surf, edge
