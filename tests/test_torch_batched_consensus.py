"""The port's run_batched_consensus (pipelines/hierarchical.py: the
batched blocks, gated consensus edges and the chunked banded polish)
against the JAX package's on tests/test_hierarchical.py::
test_run_batched_consensus_recovers's setup (make_long_scene W = 24,
block 8, stride 4), on the CPU (the batched kernels' plain versions).

Tolerances: n_edges == 23, the same gate stats, polish plane count,
span and block plane counts, poses within 1e-3 of JAX's (f32 block
solves and an f32 banded polish of up to 50 iterations on both sides),
and JAX's own bars (rotation and translation RSME at most 0.3 of the
start's).
"""

import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.pipelines import hierarchical as jh
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.pipelines import hierarchical as th

from test_torch_batched_hierarchy import CAPS, _rsme, scene  # noqa: F401


def test_run_batched_consensus_matches_jax(scene):
    R_gt, p_gt, scans, R0, p0 = scene
    kw = dict(block=8, cycles=1, **CAPS, polish_chunks=2)
    Rt, pt, it = th.run_batched_consensus(
        scans, R0, p0, polish_solver=SolverConfig(max_iters=25, u_init=0.01),
        device="cpu", **kw)
    Rj, pj, ij = jh.run_batched_consensus(
        scans, R0, p0, polish_solver=JSolverConfig(max_iters=25,
                                                   u_init=0.01), **kw)
    assert it["n_edges"] == ij["n_edges"] == 23
    for k in ("n_gated_measurements", "n_prior_pairs", "polish_planes",
              "polish_span", "block_planes"):
        assert it[k] == ij[k], k
    assert it["edges"].Zr.dtype == torch.float64
    assert np.max(np.abs(Rt - np.asarray(Rj))) <= 1e-3
    assert np.max(np.abs(pt - np.asarray(pj))) <= 1e-3
    r0, t0 = _rsme(R0, p0, R_gt, p_gt)
    r1, t1 = _rsme(Rt, pt, R_gt, p_gt)
    assert r1 < 0.3 * r0 and t1 < 0.3 * t0, (r1, r0, t1, t0)
    with pytest.raises(ValueError, match="stride"):
        th.run_device_batched(scans, R0, p0, block=4, stride=6, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.run_batched_consensus(scans, R0, p0)
