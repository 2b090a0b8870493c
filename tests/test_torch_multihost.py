"""The port's multi-process mesh (balm_tpu_torch/parallel/mesh.py) through
its demo (balm_tpu_torch/parallel/multihost_demo.py): 2 OS processes x 2
virtual CPU shards joined by torch.distributed over gloo run the
factor-sharded LM solve and the sharded evaluate, whose psum ends in an
all_reduce across the processes, against one process on one device.

Tolerances (scripts/multihost_demo.py's): poses and residual within
1e-9, the same iterations, H within 1e-7 and J within 1e-9; the JAX
package's single-process solve of the same f64 problem within 1e-9.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.pipelines import virtual as jvirtual
from balm_tpu.solver import lm as jlm
from balm_tpu_torch.parallel import mesh as mesh_mod
from balm_tpu_torch.parallel import multihost_demo


def test_two_processes_equal_one():
    rec = multihost_demo.run(2, 2, win=10, surf=16, pts=20, device="cpu",
                             timeout=300)
    assert rec["ok"], rec
    assert rec["processes"] == 2 and rec["global_shards"] == 4
    assert rec["local_shards"] == 2 and rec["backend"] == "gloo"
    # the same problem through the JAX package, one process
    cfg = jvirtual.VirtualConfig(win_size=10, surf_size=16, pts_size=20,
                                 seed=3, dtype="float64")
    R_gt, p_gt, body = jvirtual.generate(cfg)
    R0, p0 = jvirtual.perturb(R_gt, p_gt, cfg)
    f = jvirtual.build_factors(body, jnp.dtype("float64"))
    ref = jlm.damping_iter(jnp.asarray(R0), jnp.asarray(p0), f,
                           JSolverConfig(**multihost_demo.CFG))
    assert rec["iters"] == int(ref.iters)
    assert abs(rec["residual"] - float(ref.residual)) < 1e-9


def test_single_process_helpers():
    # no group: a no-op init, the whole plane range, a mesh of this
    # process's devices
    assert mesh_mod.init_distributed(None) is None
    assert mesh_mod.local_factor_slice(10) == (0, 10)
    m = mesh_mod.make_global_mesh([torch.device("cpu")] * 3)
    assert m.size == 3 and m.world == 1 and m.group is None
    with pytest.raises(ValueError, match="num_processes"):
        mesh_mod.init_distributed("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_global_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.init_distributed("127.0.0.1:1", 2, 0)
    np.testing.assert_array_equal(
        m.psum([torch.ones(2), 2 * torch.ones(2), 3 * torch.ones(2)]),
        [6.0, 6.0])


def test_slice12_imports_neither_jax_nor_balm_tpu():
    """Each new module imported in a fresh interpreter where importing
    jax or balm_tpu raises."""
    mods = ("parallel.sharded", "parallel.sharded_pallas",
            "parallel.pose_sharded", "parallel.mesh",
            "parallel.multihost_demo", "utils.scaling", "graft_entry")
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'balm_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        + "".join(f"import balm_tpu_torch.{m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'balm_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parent.parent)
