"""Block-tridiagonal direct solve of the banded BA normal equations.

Counterpart: balm_tpu/solver/banded.py — supernode_blocks (:36),
block_tridiag_factor (:88), block_tridiag_solve (:121) and solve_banded
(:148).

Every plane factor spans <= S contiguous poses, so grouping poses into
supernodes of B >= S poses makes H block-TRIDIAGONAL with (6B, 6B)
blocks, K = ceil(W / B) supernodes.  The factorization is a Thomas
recursion with pivoted LU on each pivot block (robust on the INDEFINITE
damped systems far from the optimum, the regime of the reference's dense
LDLT, bavoxel.hpp:1113-1114), O(W B^2), linear in W.  JAX runs the K
steps as lax.scans; here they are Python loops over the supernodes with
every step on the device (torch.linalg.lu_factor_ex and lu_solve, no
host read).  A singular pivot block gives non-finite values, which
solve_banded reports as ok=False with x zeroed (LM then rejects and
raises u); lu_factor_ex, unlike lu_factor, does not raise there.
"""

from __future__ import annotations

import torch


def supernode_blocks(Hband, B: int):
    """Hband (W, S, 6, 6) -> (Adiag (K, 6B, 6B), Asub (K, 6B, 6B)).

    B must be >= S so each factor couples at most two adjacent
    supernodes.  Poses beyond W are padded with identity diagonal blocks
    (decoupled; their solution entries are discarded by the caller).
    Asub[k] = H[rows of supernode k, cols of supernode k-1] (Asub[0] is
    zero).  Built by gather from the band; (6W)^2 is never formed.
    """
    W, S = Hband.shape[:2]
    assert B >= S, (B, S)
    K = -(-W // B)
    Wp = K * B
    dev = Hband.device
    Hb = Hband
    if Wp > W:
        pad = torch.zeros((Wp - W, S, 6, 6), dtype=Hband.dtype, device=dev)
        pad[:, 0] = torch.eye(6, dtype=Hband.dtype, device=dev)
        Hb = torch.cat([Hband, pad], dim=0)

    a = torch.arange(B, device=dev)
    d_ab = a[None, :] - a[:, None]                       # (B, B) col - row
    k = torch.arange(K, device=dev)[:, None, None]
    # row pose index of entry (a, b) of supernode k's blocks: kB + a
    wrow = (k * B + a[None, :, None]).expand(K, B, B)

    def gather(d):
        """Block H[wrow, wrow + d] from the band, by symmetry for d < 0
        and zero outside the band.  d: (K, B, B)."""
        dpos = torch.abs(d)
        wbase = torch.where(d >= 0, wrow, wrow + d)      # row of the
        ok = dpos < S                                    # stored block
        wb = torch.clamp(wbase, 0, Wp - 1)
        blk = Hb[wb, torch.where(ok, dpos, 0)]           # (K, B, B, 6, 6)
        blk = torch.where((d < 0)[..., None, None], blk.transpose(-1, -2),
                          blk)
        return torch.where(ok[..., None, None], blk, 0.0)

    Adiag = gather(d_ab.expand(K, B, B))
    # sub block: rows in supernode k, cols in supernode k-1:
    # col = (k-1)B + b, row = kB + a -> d = col - row = -B + (b - a)
    Asub = gather((d_ab - B).expand(K, B, B))
    Asub[0] = 0.0

    def to_mat(X):                           # (K,B,B,6,6) -> (K,6B,6B)
        return X.permute(0, 1, 3, 2, 4).reshape(K, 6 * B, 6 * B)

    return to_mat(Adiag), to_mat(Asub)


def block_tridiag_factor(Adiag, Asub):
    """Block-tridiagonal Thomas factorization with per-block pivoted LU.

    Returns (lu (K, m, m), piv (K, m), Wsub (K, m, m)) with
    D_0 = A_0,  W_k = B_k D_{k-1}^{-1},  D_k = A_k - W_k B_k^T,
    each D_k stored LU-factored.  W_0 = 0 (Asub[0] is zero; JAX solves
    against an identity factor there, which gives exactly 0).
    """
    K = Adiag.shape[0]
    lus, pivs, Ws = [], [], []
    for k in range(K):
        if k == 0:
            W = torch.zeros_like(Asub[0])
            Dk = Adiag[0]
        else:
            Bs = Asub[k]
            # W = Bs D_{k-1}^{-1}  <=>  D_{k-1}^T W^T = Bs^T
            W = torch.linalg.lu_solve(lus[-1], pivs[-1], Bs.T,
                                      adjoint=True).T
            Dk = Adiag[k] - W @ Bs.T
        lu, piv, _ = torch.linalg.lu_factor_ex(Dk)
        lus.append(lu)
        pivs.append(piv)
        Ws.append(W)
    return torch.stack(lus), torch.stack(pivs), torch.stack(Ws)


def block_tridiag_solve(lu, piv, Wsub, Bsupt, b):
    """Solve A x = b given block_tridiag_factor output; b (K, m).

    Bsupt: the (K, m, m) SUPER-diagonal blocks B_{k+1}^T shifted so
    Bsupt[k] couples x_{k+1} into row k (zero for the last supernode).
    """
    K = b.shape[0]
    ys = []
    y = torch.zeros_like(b[0])
    for k in range(K):
        y = b[k] - Wsub[k] @ y
        ys.append(y)
    xs = [None] * K
    x = torch.zeros_like(b[0])
    for k in range(K - 1, -1, -1):
        x = torch.linalg.lu_solve(lu[k], piv[k],
                                  (ys[k] - Bsupt[k] @ x)[:, None])[:, 0]
        xs[k] = x
    return torch.stack(xs)


def solve_banded(Hband, b, B: int):
    """Solve H x = b for block-banded H given as Hband (W, S, 6, 6).

    b: (6W,) flat (w-major).  Returns (x (6W,), ok 0-d bool tensor) — ok
    False when the factorization produced non-finite values (singular
    pivot), and x zeroed then.  ok stays on the device.
    """
    W = Hband.shape[0]
    Adiag, Asub = supernode_blocks(Hband, B)
    K, m = Adiag.shape[:2]
    lu, piv, Wf = block_tridiag_factor(Adiag, Asub)
    # super-diagonal blocks B_{k+1}^T, aligned so index k couples x_{k+1}
    Bsupt = torch.cat([Asub[1:].transpose(-1, -2),
                       torch.zeros_like(Asub[:1])], dim=0)
    bp = torch.cat([b, b.new_zeros(K * m - 6 * W)]).reshape(K, m)
    x = block_tridiag_solve(lu, piv, Wf, Bsupt, bp).reshape(-1)[:6 * W]
    ok = torch.all(torch.isfinite(x))
    return torch.where(ok, x, 0.0), ok
