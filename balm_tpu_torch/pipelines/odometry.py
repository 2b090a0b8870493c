"""Streaming lidar odometry and sliding-window BA (the BALM 1.0 system).

Counterpart: balm_tpu/pipelines/odometry.py — OdometryConfig (:41),
_project_so3 (:114), _bucket_pow2 (:126), _insert_rows (:134),
_pack_keys (:140), VoxelPlaneMap (:151-362), the registration core
(_plane_terms :364, _line_terms :374, _apply_step :393, _huber_w :403,
_gn_plane_fused :408, _gn_mixed_fused :429), register_scan (:453; its
association pass and GN pass are the helpers associate and gn_pass
here) and run (:531).  The reference's real-time pipeline
(BALM-old/src/balm_front_back.cpp:171-684), per incoming scan:

  1. predict the pose by constant motion  (balm_front_back.cpp:580-589)
  2. scan-to-map registration: voxel lookup into a hashed plane-landmark
     map, then an IRLS Gauss-Newton over point-to-plane (and
     point-to-line) residuals (VOXEL_DISTANCE, balmclass.hpp:1069-1231)
  3. insert the scan into the voxel map (cut_voxel incremental)
  4. every `ba_every` scans: window BA over the last `window` poses
     (LM_SLWD_VOXEL, balmclass.hpp:236-724: grid.voxelize and
     solver/lm.damping_iter) and freeze the oldest scans into the map

Where it runs: the map (VoxelPlaneMap), the association, the rescue
ladder and the bookkeeping are host numpy in float64, copied from the
JAX package.  The Gauss-Newton runs on `device` (default 'cuda'; 'cpu'
for the plain path) as plain tensor functions, `reg_iters` steps per
association pass with no host read inside them; the window BA is
solver/lm.damping_iter there with its defaults (backend 'xla',
uncentered).  Everything is float64 on every device: the residual
n.(Rx + p - c) is taken at world coordinates hundreds of metres from
the origin, and the JAX package runs this core in x64.

One divergence from JAX: torch.linalg.solve raises on a singular or
non-finite system where jnp.linalg.solve returns non-finite values that
the step's trust gate then zeros.  _apply_step uses
torch.linalg.solve_ex (which never raises) and the same gate, applied
with torch.where, so a starved or poisoned correspondence set skips the
step on both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..config import SolverConfig, VoxelConfig
from ..ops import factors as Fmod
from ..ops import lie
from ..solver import lm
from ..voxel import grid


@dataclasses.dataclass
class OdometryConfig:
    voxel_size: float = 1.0
    plane_ratio: float = 1.0 / 9.0    # map-plane eigen gate (v1 used 1/9)
    line_ratio: float = 1.0 / 16.0    # map-LINE gate: lambda_1/lambda_2
    use_lines: bool = True            # point-to-line registration factors
    min_plane_points: int = 20
    reg_iters: int = 6                 # point-to-plane GN iterations
    reg_reassociate: int = 2           # association passes (two-pass, C40)
    huber: float = 0.1                 # residual cap [m]
    window: int = 10
    ba_every: int = 5
    ba_voxel: VoxelConfig = VoxelConfig(min_observers=2, min_points=10)
    ba_solver: SolverConfig = SolverConfig(
        max_iters=8, u_init=0.01, min_planes_per_pose=1, gauge_fix=False
    )
    downsample: float = 0.25           # registration downsample
    # 27-voxel neighbor association as a RESCUE when the exact lookup
    # starves (< max(8% of points, 50) matches) — robust to pose error
    # up to ~a voxel width without admitting clutter in healthy scenes
    neighbor_assoc: bool = True
    # large-rotation rescue: when registration starves (association
    # collapse — the signature of a rotation outside the GN basin, e.g.
    # the realworld keyframe set's 7-43 deg inter-scan jumps vs the
    # constant-motion envelope of ~1 deg/scan at 10 Hz), re-initialize
    # the yaw from the scan-context sector shift between consecutive
    # scans (loopclose.sc_distance convention: R_i ~ R_{i-1} Rz(-yaw))
    # and re-register; the better-associated candidate wins.
    yaw_rescue: bool = True
    yaw_rescue_frac: float = 0.10      # rescue when used < frac * recent
    # ALSO rescue when the scan-context yaw measurement disagrees with
    # the constant-motion prediction by more than this (rad) and the
    # descriptor match is confident — association to a poisoned map can
    # stay plentiful (never "collapses") while being entirely wrong, so
    # the measurement-vs-prediction disagreement is the robust trigger
    # None = ADAPTIVE: 2.75 sector widths of the scan-context descriptor
    # (2.75 * 2pi / sc_sectors = 0.144 rad at the default 120 sectors,
    # the value the realworld study tuned by hand).  The gate must track
    # the yaw measurement's own resolution: the round-4 sensitivity sweep
    # showed a fixed gate at +50% (0.21) misses rescues on the keyframe
    # set (drift 82 deg) while the sector-derived gate survives every
    # sc_sectors variation (artifacts/rescue_sweep.json).
    yaw_rescue_disagree: float | None = None
    yaw_rescue_max_dist: float = 0.6   # sc confidence gate
    sc_rings: int = 12
    sc_sectors: int = 120              # 3 deg yaw resolution
    # third rung of the rescue ladder: when the yaw-initialized
    # registration is still starved, score a coarse pitch/roll grid
    # around the yaw init by association-inlier count (one vectorized
    # map lookup per candidate, no GN) and register from the best.
    # Covers the realworld keyframe set's off-z jumps (30 of 100
    # intervals exceed 15 deg; z-axis fraction down to 0.25).
    rot_search: bool = True
    rot_search_deg: tuple = (8.0, 16.0)   # pitch/roll ring radii
    rot_search_inlier: float = 0.15       # [m] score residual gate
    # map protection: a scan whose best registration is still starved is
    # NOT inserted into the map (its pose stays best-effort).  One badly
    # registered scan otherwise poisons the map and every later scan
    # registers against the poisoned geometry — the realworld keyframe
    # study's failure mode (a 6-scan fast-rotation burst took the whole
    # remaining trajectory down).
    insert_min_frac: float = 0.3
    # run the window BA in a worker thread while registration continues
    # (the reference's optional detached map-refine thread,
    # balm_front_back.cpp:169, 673-677).  The BA result is applied
    # DEFERRED: window poses are corrected when the solve lands, and the
    # correction at the window head is propagated to every scan
    # registered in the meantime (new_k = (new_i old_i^-1) old_k).  The
    # trajectory therefore differs slightly from the synchronous mode
    # (registration i+1..i+ba_every used the pre-BA map/poses); drift is
    # measured in artifacts/odometry_throughput.json.
    async_ba: bool = False


def _project_so3(R: np.ndarray) -> np.ndarray:
    """Nearest rotation (polar projection).  The constant-motion
    prediction R_i = R_{i-1} (R_{i-2}^T R_{i-1}) COMPOUNDS orthonormality
    error of both factors each scan — left unprojected it grows
    exponentially and was observed reaching |R| ~ 1e7 by scan 46 on the
    realworld keyframe data."""
    U, _, Vt = np.linalg.svd(R)
    S = np.eye(3)
    S[2, 2] = np.sign(np.linalg.det(U @ Vt))
    return U @ S @ Vt


def _bucket_pow2(n: int, lo: int) -> int:
    """Smallest power-of-two >= max(n, lo)."""
    m = lo
    while m < n:
        m *= 2
    return m


def _insert_rows(arr: np.ndarray, ins: np.ndarray, rows: np.ndarray):
    """np.insert for 2-D+ row blocks (positions refer to the ORIGINAL
    array, matching np.insert's semantics for sorted merges)."""
    return np.insert(arr, ins, rows, axis=0)


def _pack_keys(ks: np.ndarray) -> np.ndarray:
    """(N, 3) int voxel coords -> packed int64 (21 bits/axis, offset).

    Coordinates are clipped to the 21-bit range: a diverged upstream pose
    would otherwise overflow the bit fields and silently alias unrelated
    voxels (observed before the non-finite guards were added)."""
    off = np.int64(1) << 20
    k = np.clip(ks.astype(np.int64), -off + 1, off - 1) + off
    return (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]


class VoxelPlaneMap:
    """Hashed root-voxel map of world-frame cluster moments — INCREMENTAL.

    The reference maintains per-voxel `life`/`each_num` counters and
    routes only new points through existing nodes (bavoxel.hpp:1170-1223,
    cut_func(win_count-1) at bavoxel.hpp:771).  The equivalents here:

      * moments accumulate per packed voxel key; contributions can be
        SUBTRACTED again (moment sums form a group), so a re-optimized
        scan is swapped (remove old contribution, add new) instead of
        rebuilding the map — O(window) per BA, not O(N).
      * the plane table (eigendecomposition + gates) is refreshed only
        for DIRTY voxels, batched with one vectorized eigh call.
      * point->plane association is a vectorized searchsorted on the
        sorted packed keys (no per-point Python dict lookups).
    """

    def __init__(self, voxel_size: float, ratio: float, min_points: int,
                 line_ratio: float = 0.0):
        self.vs = voxel_size
        self.ratio = ratio
        self.line_ratio = line_ratio    # 0 disables line landmarks
        self.min_points = min_points
        # flat sorted-array store (the dict-of-4x4 form cost ~27 ms/scan
        # in Python loop overhead at realworld scale): row i of every
        # array describes voxel self.keys[i]
        self.keys = np.zeros((0,), np.int64)      # sorted packed keys
        self.C = np.zeros((0, 4, 4))              # per-voxel moment sums
        self._landc = np.zeros((0, 3))            # plane/line center
        self._landn = np.zeros((0, 3))            # plane normal
        self._landd = np.zeros((0, 3))            # line direction
        self._isplane = np.zeros((0,), bool)
        self._isline = np.zeros((0,), bool)
        self._dirty = np.zeros((0,), bool)
        self._table = None  # (sorted_keys (M,), centers (M,3), normals)
        self._ltable = None  # (sorted_keys (L,), centers (L,3), dirs (L,3))

    def state_dict(self) -> dict:
        """Complete serializable state (numpy arrays + config scalars);
        the association tables (_table/_ltable) are caches rebuilt on
        demand and deliberately not persisted."""
        return {
            "vs": np.asarray(self.vs), "ratio": np.asarray(self.ratio),
            "line_ratio": np.asarray(self.line_ratio),
            "min_points": np.asarray(self.min_points),
            "keys": self.keys, "C": self.C,
            "landc": self._landc, "landn": self._landn,
            "landd": self._landd, "isplane": self._isplane,
            "isline": self._isline, "dirty": self._dirty,
        }

    @classmethod
    def from_state(cls, d: dict) -> "VoxelPlaneMap":
        m = cls(float(d["vs"]), float(d["ratio"]),
                int(d["min_points"]), line_ratio=float(d["line_ratio"]))
        m.keys = np.asarray(d["keys"])
        m.C = np.asarray(d["C"])
        m._landc = np.asarray(d["landc"])
        m._landn = np.asarray(d["landn"])
        m._landd = np.asarray(d["landd"])
        m._isplane = np.asarray(d["isplane"])
        m._isline = np.asarray(d["isline"])
        m._dirty = np.asarray(d["dirty"])
        return m

    def scan_contribution(self, world: np.ndarray):
        """Per-voxel moment sums of one scan: (keys (K,), sums (K,4,4))."""
        ks = np.floor(world / self.vs).astype(np.int64)
        packed = _pack_keys(ks)
        q = np.concatenate([world, np.ones((len(world), 1))], -1)
        uniq, inv = np.unique(packed, return_inverse=True)
        sums = np.zeros((len(uniq), 4, 4))
        np.add.at(sums, inv, q[:, :, None] * q[:, None, :])
        return uniq, sums

    def add(self, contrib, sign: float = 1.0):
        keys, sums = contrib
        if len(keys) == 0:
            return
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.clip(pos, 0, max(len(self.keys) - 1, 0))
        hit = (self.keys[pos_c] == keys) if len(self.keys) else (
            np.zeros(len(keys), bool))
        new = ~hit
        if new.any():
            # merge-insert the new voxels, keeping the key array sorted
            nk = keys[new]
            ins = np.searchsorted(self.keys, nk)
            M, K = len(self.keys), len(nk)
            self.keys = np.insert(self.keys, ins, nk)
            self.C = _insert_rows(self.C, ins, np.zeros((K, 4, 4)))
            self._landc = _insert_rows(self._landc, ins, np.zeros((K, 3)))
            self._landn = _insert_rows(self._landn, ins, np.zeros((K, 3)))
            self._landd = _insert_rows(self._landd, ins, np.zeros((K, 3)))
            self._isplane = np.insert(self._isplane, ins, False)
            self._isline = np.insert(self._isline, ins, False)
            self._dirty = np.insert(self._dirty, ins, False)
            pos = np.searchsorted(self.keys, keys)
        np.add.at(self.C, pos, sign * sums)
        self._dirty[pos] = True

    def insert(self, world: np.ndarray):
        c = self.scan_contribution(world)
        self.add(c)
        return c

    def remove(self, contrib):
        self.add(contrib, sign=-1.0)

    def _refresh_dirty(self):
        rows = np.nonzero(self._dirty)[0]
        self._dirty[:] = False
        if len(rows) == 0:
            return
        Cs = self.C[rows]
        N = Cs[:, 3, 3]
        enough = N >= self.min_points
        vbar = Cs[:, :3, 3] / np.maximum(N, 1.0)[:, None]
        cov = Cs[:, :3, :3] / np.maximum(N, 1.0)[:, None, None] - (
            vbar[:, :, None] * vbar[:, None, :])
        # a voxel fed non-finite points (diverged upstream pose) or left
        # with float residue after remove/insert swaps must not crash the
        # batched eigh — mark it not-a-landmark instead
        bad = ~np.isfinite(cov).all(axis=(1, 2))
        if bad.any():
            cov[bad] = np.eye(3)
            enough = enough & ~bad
        cov = 0.5 * (cov + np.swapaxes(cov, 1, 2))
        lam, U = np.linalg.eigh(cov)
        ok = enough & (
            lam[:, 0] / np.maximum(lam[:, 1], 1e-30) < self.ratio)
        # line landmark: thin in TWO directions, long in one
        # (balmclass.hpp's line correspondences; v1 edge landmarks)
        okl = enough & ~ok & (
            lam[:, 1] / np.maximum(lam[:, 2], 1e-30) < self.line_ratio)
        self._isplane[rows] = ok
        self._isline[rows] = okl
        self._landc[rows] = vbar
        self._landn[rows] = U[:, :, 0]
        self._landd[rows] = U[:, :, 2]

    def _refresh_tables(self):
        if self._dirty.any() or self._table is None:
            self._refresh_dirty()
            m = self._isplane
            self._table = (self.keys[m], self._landc[m], self._landn[m])
            ml = self._isline
            self._ltable = (self.keys[ml], self._landc[ml], self._landd[ml])

    def plane_table(self):
        """-> (sorted packed keys (M,), centers (M,3), normals (M,3))."""
        self._refresh_tables()
        return self._table

    def line_table(self):
        """-> (sorted packed keys (L,), centers (L,3), directions (L,3))."""
        self._refresh_tables()
        return self._ltable

    @staticmethod
    def _lookup_in(skeys, world, vs):
        if len(skeys) == 0:
            return np.full(len(world), -1, np.int64)
        packed = _pack_keys(np.floor(world / vs).astype(np.int64))
        pos = np.searchsorted(skeys, packed)
        pos = np.clip(pos, 0, len(skeys) - 1)
        hit = skeys[pos] == packed
        return np.where(hit, pos, -1)

    @staticmethod
    def _lookup_neighbors(skeys, cents, norms, world, vs):
        """27-voxel association: each point may match a landmark in its
        own OR any face/edge/corner-adjacent voxel; among hits, pick the
        smallest point-to-plane distance.  The exact-voxel lookup loses
        points that sit within a voxel-width of their true plane under
        pose error — exactly the aggressive-rotation regime where the
        front-end needs correspondences most (cf. the reference's kd-tree
        radius search, balmclass.hpp scan2map)."""
        if len(skeys) == 0:
            return np.full(len(world), -1, np.int64)
        base = np.floor(world / vs).astype(np.int64)
        best = np.full(len(world), -1, np.int64)
        # gate: a match more than half a voxel out of plane is geometry
        # from somewhere else, not a displaced correspondence
        bestd = np.full(len(world), 0.5 * vs)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    packed = _pack_keys(base + np.array([dx, dy, dz]))
                    pos = np.searchsorted(skeys, packed)
                    pos = np.clip(pos, 0, len(skeys) - 1)
                    hit = skeys[pos] == packed
                    if not hit.any():
                        continue
                    d = np.abs(np.sum(
                        norms[pos] * (world - cents[pos]), axis=-1))
                    upd = hit & (d < bestd)
                    best[upd] = pos[upd]
                    bestd[upd] = d[upd]
        return best

    def lookup(self, world: np.ndarray, neighbors: bool = False):
        """Vectorized association: rows into the plane table (-1 = none)."""
        skeys, cents, norms = self.plane_table()
        if neighbors:
            return self._lookup_neighbors(skeys, cents, norms, world,
                                          self.vs)
        return self._lookup_in(skeys, world, self.vs)

    def lookup_lines(self, world: np.ndarray) -> np.ndarray:
        return self._lookup_in(self.line_table()[0], world, self.vs)



def _device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' for "
                           "the plain PyTorch path")
    return device


def _plane_terms(R, p, pts, normals, centers, wgt):
    """Weighted point-to-plane normal equations: (H (6,6), g (6,), cost)."""
    x = pts @ R.T + p
    r = torch.sum(normals * (x - centers), dim=-1)
    # left-perturbation jacobian rows: [x cross n ; n]
    J = torch.cat([torch.linalg.cross(x, normals, dim=-1), normals], dim=-1)
    Jw_ = J * wgt[:, None]
    return Jw_.T @ J, Jw_.T @ r, torch.sum(wgt * r * r)


def _line_terms(R, p, lpts, ldirs, lcents, lwgt):
    """Point-to-LINE normal equations (the reference's odometry handles
    both correspondence types, balmclass.hpp:1069-1231):
        E = sum w_l |P_perp (Rx+p-c)|^2,  P_perp = I - d d^T.
    """
    xl = lpts @ R.T + p
    e0 = xl - lcents
    proj = torch.sum(ldirs * e0, dim=-1)
    e = e0 - ldirs * proj[:, None]                       # (L, 3)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    A = eye3 - ldirs[:, :, None] * ldirs[:, None, :]     # (L, 3, 3)
    hatx = lie.hat(xl)
    Jl = torch.cat(
        [-torch.einsum("lab,lbc->lac", A, hatx), A], dim=-1)  # (L,3,6)
    H = torch.einsum("l,lai,laj->ij", lwgt, Jl, Jl)
    g = torch.einsum("l,lai,la->i", lwgt, Jl, e)
    return H, g, torch.sum(lwgt * torch.sum(e * e, dim=-1))


def _apply_step(R, p, H, g):
    """One damped GN step, gated on the device.  solve_ex, not solve:
    torch.linalg.solve raises on a singular or non-finite H, where the
    JAX package's solve returns non-finite values; the trust gate below
    then skips the step (a starved or poisoned correspondence set must
    not emit a NaN or runaway step — a huge but finite dx overflows f64
    within a few constant-motion extrapolations downstream).  A failed
    factorization (info != 0) is skipped the same way."""
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    dx, info = torch.linalg.solve_ex(H + 1e-6 * eye6, -g)
    ok = (torch.isfinite(dx).all() & (torch.linalg.norm(dx) < 1.0)
          & (info == 0))
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    return lie.se3_left_update(R, p, dx)


def _huber_w(r, huber):
    a = torch.abs(r)
    return torch.where(a < huber, torch.ones_like(r),
                       huber / torch.clamp(a, min=1e-12))


def _gn_plane_fused(R, p, pts, normals, centers, mask, huber, *, iters):
    """The IRLS registration inner loop (reweight + GN step, x `iters`)
    on the tensors' device with no host read: weights from the residuals
    at the current pose, then one GN step with those weights.  Returns
    (R, p, cost of the last step's linearization point)."""
    cost = torch.zeros((), dtype=R.dtype, device=R.device)
    for _ in range(iters):
        x = pts @ R.T + p
        r = torch.sum(normals * (x - centers), dim=-1)
        w = mask * _huber_w(r, huber)
        H, g, cost = _plane_terms(R, p, pts, normals, centers, w)
        R, p = _apply_step(R, p, H, g)
    return R, p, cost


def _gn_mixed_fused(R, p, pts, normals, centers, mask, lpts, ldirs, lcents,
                    lmask, huber, *, iters):
    """The IRLS loop over plane + line residuals (see _gn_plane_fused)."""
    cost = torch.zeros((), dtype=R.dtype, device=R.device)
    for _ in range(iters):
        x = pts @ R.T + p
        r = torch.sum(normals * (x - centers), dim=-1)
        w = mask * _huber_w(r, huber)
        xl = lpts @ R.T + p
        e0 = xl - lcents
        el = torch.linalg.norm(
            e0 - ldirs * torch.sum(ldirs * e0, -1, keepdim=True), dim=-1)
        wl = lmask * _huber_w(el, huber)
        Hp, gp, cp = _plane_terms(R, p, pts, normals, centers, w)
        Hl, gl, cl = _line_terms(R, p, lpts, ldirs, lcents, wl)
        R, p = _apply_step(R, p, Hp + Hl, gp + gl)
        cost = cp + cl
    return R, p, cost


def _to_device(arrays, device):
    """Float64 (n, k_i) numpy blocks -> tensors on `device`, through one
    host-to-device copy of their concatenation."""
    cat = torch.from_numpy(np.concatenate(
        [a.reshape(len(a), -1) for a in arrays], axis=1))
    cat = cat.to(device)
    out, c = [], 0
    for a in arrays:
        k = int(np.prod(a.shape[1:]))
        out.append(cat[:, c:c + k].reshape(a.shape))
        c += k
    return out


def associate(pts: np.ndarray, Rh, ph, vmap: VoxelPlaneMap,
              cfg: OdometryConfig, device):
    """One association pass of register_scan at the pose (Rh, ph): the
    map lookups on the host, then the correspondence arrays padded to
    power-of-two buckets and copied to `device`.  Returns None when
    fewer than 20 plane matches are found, else (n_used, planes, lines):
    planes (P, N, C, mask) for the GN, lines (P, D, C, mask) where
    cfg.use_lines and the map holds a line, else None."""
    _, cents, norms = vmap.plane_table()
    lkeys, lcents, ldirs = vmap.line_table()
    world = pts @ Rh.T + ph
    rows = vmap.lookup(world)
    sel = rows >= 0
    # neighbor RESCUE: the exact-voxel lookup loses correspondences
    # exactly when the prediction is worst (aggressive rotation /
    # accumulated drift).  Only when association starves is the
    # search widened to the 27 voxels — in healthy scenes the wider
    # search would admit off-plane clutter (e.g. pole feet onto the
    # floor)
    if cfg.neighbor_assoc and sel.sum() < max(0.08 * len(pts), 50):
        rows = vmap.lookup(world, neighbors=True)
        sel = rows >= 0
    if sel.sum() < 20:
        return None
    n_used = int(sel.sum())
    # power-of-two buckets of the correspondence arrays: the padded
    # rows carry zero weight (normals, mask), and a fixed set of
    # shapes lets the loop be captured once per bucket
    m = _bucket_pow2(n_used, 1024)
    P = np.zeros((m, 3)); P[:n_used] = pts[sel]
    Nn = np.zeros((m, 3)); Nn[:n_used] = norms[rows[sel]]
    Cc = np.zeros((m, 3)); Cc[:n_used] = cents[rows[sel]]
    mask = np.zeros((m, 1)); mask[:n_used] = 1.0
    P, Nn, Cc, mask = _to_device((P, Nn, Cc, mask), device)
    if not (cfg.use_lines and len(lkeys) > 0):
        return n_used, (P, Nn, Cc, mask[:, 0]), None
    lrows = vmap.lookup_lines(world)
    lsel = lrows >= 0
    nl = int(lsel.sum())
    ml = _bucket_pow2(max(nl, 1), 256)
    Pl = np.zeros((ml, 3)); Pl[:nl] = pts[lsel].reshape(-1, 3)
    Dl = np.tile(np.array([0.0, 0.0, 1.0]), (ml, 1))
    Dl[:nl] = ldirs[lrows[lsel]].reshape(-1, 3)
    Cl = np.zeros((ml, 3)); Cl[:nl] = lcents[lrows[lsel]].reshape(-1, 3)
    lmask = np.zeros((ml, 1)); lmask[:nl] = 1.0
    Pl, Dl, Cl, lmask = _to_device((Pl, Dl, Cl, lmask), device)
    return n_used + nl, (P, Nn, Cc, mask[:, 0]), (Pl, Dl, Cl, lmask[:, 0])


def gn_pass(R, p, planes, lines, cfg: OdometryConfig):
    """The fused GN of one association pass (associate's planes and
    lines): the mixed plane + line GN where lines are given."""
    if lines is None:
        return _gn_plane_fused(R, p, *planes, cfg.huber, iters=cfg.reg_iters)
    return _gn_mixed_fused(R, p, *planes, *lines, cfg.huber,
                           iters=cfg.reg_iters)


def register_scan(scan: np.ndarray, R0, p0, vmap: VoxelPlaneMap,
                  cfg: OdometryConfig, *, device="cuda"):
    """Point-to-plane (+ point-to-line) registration against the map.
    Association on the host, the GN on `device`, float64.  Returns (R,
    p, n_used) with R, p numpy."""
    _, cents, _ = vmap.plane_table()
    if len(cents) == 0:
        return R0, p0, 0
    device = torch.device(device)
    pts = scan
    if cfg.downsample > 0:
        pts = grid.down_sample_voxel(pts, cfg.downsample)
    Rh = np.asarray(R0, np.float64)
    ph = np.asarray(p0, np.float64)
    R = torch.as_tensor(Rh, device=device)
    p = torch.as_tensor(ph, device=device)
    n_used = 0
    for k_pass in range(cfg.reg_reassociate):
        if k_pass:
            Rh, ph = R.cpu().numpy(), p.cpu().numpy()
        corr = associate(pts, Rh, ph, vmap, cfg, device)
        if corr is None:
            break
        n_used, planes, lines = corr
        R, p, _ = gn_pass(R, p, planes, lines, cfg)
    R = R.cpu().numpy()
    p = p.cpu().numpy()
    # registration sanity: non-finite, or total correction beyond what a
    # one-scan prediction error can be (the map is at most a voxel-few
    # off), means the solve latched onto wrong geometry — keep the
    # prediction and let the map grow along it instead
    dp = np.linalg.norm(p - np.asarray(p0))
    cosang = np.clip((np.trace(np.asarray(R0).T @ R) - 1.0) / 2.0, -1, 1)
    if not (np.isfinite(R).all() and np.isfinite(p).all()) or (
            dp > 5.0 * vmap.vs or np.arccos(cosang) > 0.8):
        return np.asarray(R0), np.asarray(p0), 0
    return R, p, n_used


def run(scans: List[np.ndarray], cfg: OdometryConfig = OdometryConfig(),
        R_init=None, p_init=None, *, verbose: bool = False,
        checkpoint_path=None, checkpoint_every: int = 0,
        resume: bool = False, stop_after_scan: int = 0, device="cuda"):
    """Process scans sequentially. Returns (R (W,3,3), p (W,3), info),
    numpy float64.

    The registration GN and the window BA run on `device` (default
    'cuda'; 'cpu' for the plain path), the rest on the host.
    Checkpoint/resume: with `checkpoint_path` set and
    `checkpoint_every > 0`, the complete loop state (trajectory,
    incremental VoxelPlaneMap, in-window contribution ledger) is saved
    atomically every k scans (utils/checkpoint.save_odometry, the JAX
    package's format); `resume=True` continues from the file if it
    exists, reproducing the uninterrupted trajectory exactly.
    `stop_after_scan` ends the loop early after that scan (checkpointing
    first) — the stand-in for a preemption signal handler.

    async_ba runs each window BA on a worker thread while registration
    continues.  Its tensors are on `device` and its kernels go to the
    thread's current stream, which is the device's default stream (no
    stream is set anywhere in this module): they queue behind and
    between the registration's launches; what overlaps is the host work
    of both threads (association, voxelization, the solver's loop).
    """
    device = _device(device, "odometry.run")
    W = len(scans)
    R = np.tile(np.eye(3), (W, 1, 1))
    p = np.zeros((W, 3))
    if R_init is not None:
        R[0] = R_init
    if p_init is not None:
        p[0] = p_init

    vmap = VoxelPlaneMap(cfg.voxel_size, cfg.plane_ratio,
                         cfg.min_plane_points,
                         line_ratio=cfg.line_ratio if cfg.use_lines else 0.0)

    def _register(scan, R0, p0):
        return register_scan(scan, R0, p0, vmap, cfg, device=device)

    # scan-context state for the large-rotation yaw rescue
    sc_state = None
    if cfg.yaw_rescue:
        # lazy: loopclose imports this module at its top
        from . import loopclose as LC

        s0 = scans[0]
        r = np.hypot(s0[:, 0], s0[:, 1])
        sc_rmax = float(np.percentile(r, 95)) if len(r) else 1.0
        sc_zlo = float(np.percentile(s0[:, 2], 5)) if len(s0) else 0.0
        sc_zhi = float(np.percentile(s0[:, 2], 95)) if len(s0) else 1.0

        def _desc(s):
            return LC.scan_context(s, cfg.sc_rings, cfg.sc_sectors,
                                   sc_rmax, sc_zlo, sc_zhi)

        sc_state = {"prev": None}   # filled after the resume block

        def _sc_rel_yaw(scan_cur):
            """(relative yaw estimate psi with R_i ~ R_{i-1} Rz(psi),
            sc distance, descriptor) from consecutive scan contexts."""
            d_cur = _desc(scan_cur)
            dist, shift = LC.sc_distance(
                sc_state["prev"][None], d_cur[None], 8)
            psi = -LC.shift_to_yaw(int(shift[0]), cfg.sc_sectors)
            return psi, float(dist[0]), d_cur

        def _rotz(a):
            ca, sa = np.cos(a), np.sin(a)
            return np.array([[ca, -sa, 0.0], [sa, ca, 0.0],
                             [0.0, 0.0, 1.0]])

        def _score_poses(pts, Rcs, pc, gate=None):
            """Association-inlier counts for a batch of candidate poses:
            points that land in a mapped plane voxel within the residual
            gate — one vectorized lookup over all candidates, no GN.
            With the tight gate (registration quality) this separates
            correct poses from inlier-rich aliases that fool the raw
            association count."""
            C = len(Rcs)
            world = (np.einsum("cij,nj->cni", np.stack(Rcs), pts)
                     + pc).reshape(C * len(pts), 3)
            rows = vmap.lookup(world)
            sel = rows >= 0
            if not sel.any():
                return np.zeros(C, np.int64)
            _, cents, norms = vmap.plane_table()
            d = np.abs(np.einsum(
                "ij,ij->i", world[sel] - cents[rows[sel]],
                norms[rows[sel]]))
            hit = np.zeros(C * len(pts), bool)
            hit[np.nonzero(sel)[0]] = d < (gate or cfg.rot_search_inlier)
            return hit.reshape(C, len(pts)).sum(axis=1)
    # per-scan map contributions, kept only while the scan can still be
    # re-optimized by a window BA; older scans are frozen into the map
    # (the incremental marginalization, reference to_margi/marginalize
    # bavoxel.hpp:778-816, 948-963)
    contribs: Dict[int, tuple] = {}
    contribs[0] = vmap.insert(scans[0] @ R[0].T + p[0])
    info = {"reg_points": [], "ba_runs": 0}
    i_start = 1

    if checkpoint_path is not None:
        import pathlib

        from ..utils import checkpoint as ckpt

        cpath = pathlib.Path(checkpoint_path)
        if resume and cpath.exists():
            (i_start, Rc, pc, vstate, contribs, info) = (
                ckpt.load_odometry(cpath))
            R[:len(Rc)] = Rc[:W]
            p[:len(pc)] = pc[:W]
            vmap = VoxelPlaneMap.from_state(vstate)
            info["resumed_at"] = i_start

    if sc_state is not None:
        # the yaw-measurement partner is the scan before the first loop
        # iteration — after a resume that is scan i_start - 1, not scan 0
        # (a wrong pair would fabricate a large yaw "measurement" and
        # could fire a spurious rescue on the first resumed scan)
        sc_state["prev"] = _desc(scans[max(i_start - 1, 0)])

    # adaptive yaw-disagreement gate: 2.75 scan-context sector widths
    # (see OdometryConfig.yaw_rescue_disagree)
    disagree_gate = (cfg.yaw_rescue_disagree
                     if cfg.yaw_rescue_disagree is not None
                     else 2.75 * 2.0 * np.pi / cfg.sc_sectors)

    # ---- window BA machinery (sync inline, or one detached worker) ----
    ba_pending = None          # {"thread", "out", "idx"} when in flight

    def _ba_solve(scans_w, Rw0, pw0):
        """Voxelize + solve one window; a pure function of its inputs,
        so it can run on a worker thread."""
        vres = grid.voxelize(scans_w, Rw0, pw0, cfg.ba_voxel,
                             dtype=np.float64, pad_to=512)
        if vres.num_planes < 3:
            return None
        ft = Fmod.factors_from_numpy(vres.factors, device=device,
                                     dtype=torch.float64)
        res = lm.damping_iter(torch.as_tensor(Rw0, device=device),
                              torch.as_tensor(pw0, device=device), ft,
                              cfg.ba_solver)
        return res.R.cpu().numpy(), res.p.cpu().numpy()

    def _ba_apply(idx, job, i_now):
        """Land a finished window solve: re-anchor the window at pose lo,
        propagate the head-pose correction to scans registered since the
        window closed, swap the re-posed scans' map contributions."""
        if job is None:
            return
        Rw, pw = job
        lo, i_ba = idx[0], idx[-1]
        R_old = R[i_ba].copy()
        p_old = p[i_ba].copy()
        A = R[lo] @ Rw[0].T
        b = p[lo] - A @ pw[0]
        for j, jj in enumerate(idx):
            R[jj] = _project_so3(A @ Rw[j])
            p[jj] = A @ pw[j] + b
        if i_now > i_ba:
            # deferred landing: scans i_ba+1..i_now were chained from the
            # pre-BA head pose — move them by the head correction
            D = _project_so3(R[i_ba] @ R_old.T)
            bD = p[i_ba] - D @ p_old
            for k in range(i_ba + 1, i_now + 1):
                R[k] = _project_so3(D @ R[k])
                p[k] = D @ p[k] + bD
        info["ba_runs"] += 1
        # swap only the re-posed scans' contributions — O(window + lag),
        # the map's frozen mass is untouched
        for jj in list(contribs):
            if jj >= lo:
                vmap.remove(contribs[jj])
                contribs[jj] = vmap.insert(scans[jj] @ R[jj].T + p[jj])

    def _ba_launch(idx):
        import threading

        out = {}
        args = ([scans[j] for j in idx], R[idx].copy(), p[idx].copy())

        def work():
            out["job"] = _ba_solve(*args)

        th = threading.Thread(target=work, daemon=True)
        th.start()
        return {"thread": th, "out": out, "idx": idx}

    def _ba_join_apply(pending, i_now):
        if pending is not None:
            pending["thread"].join()
            _ba_apply(pending["idx"], pending["out"].get("job"), i_now)
        return None

    def _ba_poll_apply(pending, i_now):
        if pending is not None and not pending["thread"].is_alive():
            return _ba_join_apply(pending, i_now)
        return pending

    for i in range(i_start, W):
        # constant-motion prediction (balm_front_back.cpp:580-589)
        if i >= 2:
            dR = R[i - 2].T @ R[i - 1]
            dp = R[i - 2].T @ (p[i - 1] - p[i - 2])
            R[i] = _project_so3(R[i - 1] @ dR)
            p[i] = R[i - 1] @ dp + p[i - 1]
        else:
            R[i] = R[i - 1]
            p[i] = p[i - 1]

        R_pred = R[i].copy()
        p_pred = p[i].copy()
        R[i], p[i], used = _register(scans[i], R[i], p[i])
        if cfg.yaw_rescue:
            psi, sc_dist, d_cur = _sc_rel_yaw(scans[i])
            rel = R[i - 1].T @ R_pred
            yaw_pred = float(np.arctan2(rel[1, 0], rel[0, 0]))
            dis = abs((psi - yaw_pred + np.pi) % (2 * np.pi) - np.pi)
            # hard-scan triggers: association collapse (self-scaled —
            # counts vary 100x between scenes), the yaw measurement
            # contradicting the constant-motion prediction, or simply a
            # fast rotation (registration from any single init is
            # unreliable there; inlier-rich aliases win silently)
            recent = info["reg_points"][-5:]
            healthy = float(np.median(recent)) if recent else float(used)
            starved = used < max(cfg.yaw_rescue_frac * healthy, 50.0)
            contradicted = (dis > disagree_gate
                            and sc_dist < cfg.yaw_rescue_max_dist)
            fast = (abs(psi) > disagree_gate
                    and sc_dist < cfg.yaw_rescue_max_dist)
            if starved or contradicted or fast:
                pts_ds = (scans[i] if cfg.downsample <= 0 else
                          grid.down_sample_voxel(scans[i],
                                                 cfg.downsample))
                tight = 0.05
                # candidates ranked by tight-inlier quality, not raw
                # association count; a fast but well registered scan
                # (high primary quality, yaw agreeing with the
                # measurement) skips the rescue registrations — the
                # quality check is one batched lookup
                q0 = _score_poses(pts_ds, [R[i]], p[i], gate=tight)[0]
                best = (R[i], p[i], used, q0)
                primary_ok = (not starved and not contradicted
                              and q0 >= 0.5 * len(pts_ds))
                if not primary_ok:
                    R_base = _project_so3(R[i - 1] @ _rotz(psi))
                    R2, p2, used2 = _register(scans[i], R_base,
                                              p_pred.copy())
                    q2 = _score_poses(pts_ds, [R2], p2, gate=tight)[0]
                    if q2 > best[3]:
                        best = (R2, p2, used2, q2)
                        info["yaw_rescues"] = info.get("yaw_rescues",
                                                       0) + 1
                    # third rung: coarse pitch/roll search around the
                    # yaw init, scored by loose inliers in one batched
                    # lookup over all candidates
                    if cfg.rot_search and (starved or best[3] <
                                           0.6 * len(pts_ds)):
                        cands = [np.zeros(3)]
                        for rr in cfg.rot_search_deg:
                            for k8 in range(8):
                                phi = k8 * np.pi / 4
                                cands.append(np.deg2rad(rr) * np.array(
                                    [np.cos(phi), np.sin(phi), 0.0]))
                        Rcs = [_project_so3(R_base @ lie.so3_exp(
                            torch.as_tensor(wv)).numpy()) for wv in cands]
                        scores = _score_poses(pts_ds, Rcs, p_pred)
                        best_R = Rcs[int(np.argmax(scores))]
                        R3, p3, used3 = _register(scans[i], best_R,
                                                  p_pred.copy())
                        q3 = _score_poses(pts_ds, [R3], p3,
                                          gate=tight)[0]
                        if q3 > best[3]:
                            best = (R3, p3, used3, q3)
                            info["rot_searches"] = info.get(
                                "rot_searches", 0) + 1
                R[i], p[i], used = best[0], best[1], best[2]
            sc_state["prev"] = d_cur
        info["reg_points"].append(used)
        recent = info["reg_points"][-6:-1]
        healthy = float(np.median(recent)) if recent else float(used)
        if used >= cfg.insert_min_frac * healthy or len(vmap.keys) == 0:
            contribs[i] = vmap.insert(scans[i] @ R[i].T + p[i])
        else:
            info["skipped_inserts"] = info.get("skipped_inserts", 0) + 1
        # freeze scans that can no longer be touched by any window BA
        for j in [j for j in contribs if j <= i - cfg.window]:
            del contribs[j]

        # window BA (LM_SLWD_VOXEL equivalent)
        if cfg.ba_every > 0 and i >= cfg.window - 1 and (
                (i + 1) % cfg.ba_every == 0 or i == W - 1):
            lo = i - cfg.window + 1
            idx = list(range(lo, i + 1))
            if cfg.async_ba and i < W - 1:
                # detached refine (balm_front_back.cpp:673-677): at most
                # one solve in flight; a due BA first lands the previous
                ba_pending = _ba_join_apply(ba_pending, i)
                ba_pending = _ba_launch(idx)
            else:
                # land any in-flight detached solve first: the final
                # _ba_join_apply below would otherwise overwrite this
                # sync solve's refined poses with a stale result
                # computed from pre-correction state
                ba_pending = _ba_join_apply(ba_pending, i)
                job = _ba_solve([scans[j] for j in idx],
                                R[idx].copy(), p[idx].copy())
                _ba_apply(idx, job, i)
        ba_pending = _ba_poll_apply(ba_pending, i)
        if verbose and i % 10 == 0:
            print(f"scan {i}: reg pts {used}, planes "
                  f"{len(vmap.plane_table()[1])}")

        stopping = stop_after_scan and i >= stop_after_scan and i < W - 1
        if checkpoint_path is not None and checkpoint_every > 0 and (
                (i + 1) % checkpoint_every == 0 or stopping):
            # a checkpoint must capture a landed state: join any
            # in-flight window solve first so resume reproduces it
            ba_pending = _ba_join_apply(ba_pending, i)
            ckpt.save_odometry(cpath, i + 1, R, p, vmap.state_dict(),
                               contribs, info)
        if stopping:
            info["stopped_at"] = i
            break

    ba_pending = _ba_join_apply(ba_pending, W - 1)
    return R, p, info
