"""The port's command line (`python -m balm_tpu_torch ...`,
balm_tpu_torch/__main__.py) and its timers and device trace
(balm_tpu_torch/utils/tracing.py) against the JAX package's, on the CPU.

Tolerances:
  * _apply_sets, _coerce, _jsonable: equal (the same parsing; tensors
    give the lists and scalars numpy arrays give)
  * `virtual --cpu`, `optimize --cpu` and `realworld --cpu --mesh 2`
    against balm_tpu.__main__'s JSON line on the same arguments: the same
    keys and integers, every float within 1e-9 relative (the same
    float64 solves through two packages; their products and sums round
    in another order); realworld's seconds and the port's own keys
    (assoc_backend, assoc_attempts_s, backend) aside
  * utils/metrics.pose_rsme on float32 poses against float64 ground
    truth: promoted to float64 like jnp's, within 1e-9 of JAX's
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from balm_tpu import __main__ as jcli
from balm_tpu_torch import __main__ as cli
from balm_tpu_torch.utils import tracing

from test_hierarchical import make_long_scene, perturb_drift
from test_torch_realworld import write_pcd, write_pose_rows

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL_CLI = 1e-9
VIRTUAL_SETS = ["--set", "win_size=6", "--set", "surf_size=8",
                "--set", "pts_size=15"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same_summary(got, ref):
    assert set(got) == set(ref)
    for k, b in ref.items():
        a = got[k]
        if isinstance(b, float):
            assert abs(a - b) <= TOL_CLI * max(abs(b), 1e-300), (k, a, b)
        else:
            assert a == b, (k, a, b)


def test_set_override_dotted_paths():
    from balm_tpu_torch.pipelines import realworld

    cfg = cli._apply_sets(
        realworld.RealworldConfig(),
        ["voxel.voxel_size=2.5", "solver.max_iters=3", "max_scans=7",
         "merge_planes=true", "dtype=float32",
         "voxel.eigen_ratio=0.1,0.2,0.3"])
    assert cfg.voxel.voxel_size == 2.5
    assert cfg.solver.max_iters == 3
    assert cfg.max_scans == 7
    assert cfg.merge_planes is True
    assert cfg.dtype == "float32"
    assert cfg.voxel.eigen_ratio == (0.1, 0.2, 0.3)
    # the shared class-level default instances must NOT be mutated
    assert realworld.RealworldConfig().voxel.voxel_size == 1.0
    assert realworld.RealworldConfig().solver.max_iters == 10


def test_set_override_rejects_unknown_field():
    from balm_tpu_torch.pipelines import virtual

    with pytest.raises(SystemExit):
        cli._apply_sets(virtual.VirtualConfig(), ["no_such_field=1"])
    with pytest.raises(SystemExit):
        cli._apply_sets(virtual.VirtualConfig(), ["win_size"])


def test_coerce_matches_jax():
    for cur, text in ((5, "none"), (True, "off"), (None, "12"),
                      (None, "/some/path"), (1.0, "2.5"), ((1.0,), "1,2"),
                      ("a", "'b'")):
        assert cli._coerce(cur, text) == jcli._coerce(cur, text)
    assert cli._coerce(None, "12") == 12
    with pytest.raises(ValueError):
        cli._coerce(True, "maybe")


def test_jsonable_handles_tensors():
    assert cli._jsonable(torch.arange(4.0)) == [0.0, 1.0, 2.0, 3.0]
    assert cli._jsonable(torch.tensor(1.5, dtype=torch.float64)) == 1.5
    assert cli._jsonable(torch.tensor(7)) == 7
    big = cli._jsonable(torch.zeros(20, 20))
    assert isinstance(big, str) and "(20, 20)" in big
    assert cli._jsonable({"a": (torch.tensor(float("nan")), np.float32(2))}) \
        == {"a": [None, 2.0]}
    assert cli._jsonable(np.zeros((20, 20))) == jcli._jsonable(
        np.zeros((20, 20)))


def test_virtual_cpu_matches_jax_cli(capsys, tmp_path):
    out_json = tmp_path / "virtual.json"
    assert cli.main(["virtual", "--cpu", *VIRTUAL_SETS,
                     "--json", str(out_json)]) == 0
    got = _last_json(capsys)
    assert jcli.main(["virtual", *VIRTUAL_SETS]) == 0
    ref = _last_json(capsys)
    _same_summary(got, ref)
    assert got["rsme_rot_deg"] < got["rsme_rot_deg_initial"]
    assert "result" not in got
    assert json.loads(out_json.read_text()) == got


@pytest.fixture(scope="module")
def scan_dir(tmp_path_factory):
    """A 10-scan scene written as the reference dataset."""
    d = tmp_path_factory.mktemp("cli_scene")
    R, p, scans = make_long_scene(W=10, n_planes=50, pts_per=80, seed=3)
    R0, p0 = perturb_drift(R, p, seed=4)
    for i, s in enumerate(scans):
        write_pcd(d / f"full{i}.pcd", s)
    write_pose_rows(d / "alidarPose.csv", R0, p0, 0.1 * np.arange(10))
    return d


def test_optimize_cpu_matches_jax_cli(capsys, scan_dir, tmp_path):
    csv = tmp_path / "port.csv"
    assert cli.main(["optimize", "--cpu", "--data-dir", str(scan_dir),
                     "--out-csv", str(csv)]) == 0
    got = _last_json(capsys)
    jcsv = tmp_path / "jax.csv"
    assert jcli.main(["optimize", "--data-dir", str(scan_dir),
                      "--out-csv", str(jcsv)]) == 0
    ref = _last_json(capsys)
    ref["trajectory_csv"] = str(csv)
    _same_summary(got, ref)
    assert got["residual_final"] < got["residual_initial"]
    a = np.loadtxt(csv, delimiter=",", usecols=range(4))
    b = np.loadtxt(jcsv, delimiter=",", usecols=range(4))
    assert a.shape == b.shape == (40, 4)
    assert np.max(np.abs(a - b)) < 1e-8


def test_mesh_exits_nonzero_and_card_required(capsys, scan_dir):
    """`realworld --cpu --mesh 2` runs the factor-parallel solve on 2
    virtual CPU shards and prints JAX's `realworld --mesh 2` line (its
    seconds aside); without --cpu it needs 2 visible cards and exits
    non-zero with fewer, as JAX's visible-devices check."""
    assert cli.main(["realworld", "--cpu", "--mesh", "2", "--data-dir",
                     str(scan_dir)]) == 0
    got = _last_json(capsys)
    assert jcli.main(["realworld", "--mesh", "2", "--data-dir",
                      str(scan_dir)]) == 0
    ref = _last_json(capsys)
    assert got["mesh_devices"] == 2 and got["backend"] == "xla"
    assert set(ref) - {"t_load_s", "t_assoc_s", "t_solve_s"} <= set(got)
    _same_summary({k: got[k] for k in ref if not k.startswith("t_")},
                  {k: v for k, v in ref.items() if not k.startswith("t_")})
    if torch.cuda.device_count() < 2:
        r = subprocess.run(
            [sys.executable, "-m", "balm_tpu_torch", "realworld", "--mesh",
             "2", "--data-dir", str(scan_dir)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and r.stdout == ""
        assert ("devices visible" in r.stderr
                or "no CUDA device" in r.stderr), r.stderr[-2000:]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["virtual", *VIRTUAL_SETS])


def test_phase_timers():
    t = tracing.PhaseTimers()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["b"]["count"] == 1
    assert "a" in t.report()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tracing.device_trace(str(tmp_path / "trace")) as path:
        torch.linalg.eigh(torch.eye(3) + 0.1)
    path = pathlib.Path(path)
    assert path.parent == tmp_path / "trace" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("eigh" in str(e.get("name", "")) for e in events)


def test_slice11_imports_neither_jax_nor_balm_tpu():
    """Each new module imported in a fresh interpreter where importing
    jax or balm_tpu raises."""
    mods = ("baselines", "baselines.balm1", "baselines.ef", "baselines.pa",
            "baselines.pa_whitened", "baselines.bareg", "utils.tracing",
            "__main__")
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
                   cwd=REPO)


def test_pose_rsme_promotes_mixed_precisions():
    """`optimize` on the card scores the float32 solve against the
    float64 input: pose_rsme promotes as jnp does."""
    from balm_tpu.utils import metrics as jmetrics
    from balm_tpu_torch.utils import metrics

    rng = np.random.default_rng(2)
    R = np.linalg.qr(rng.normal(size=(5, 3, 3)))[0]
    R *= np.sign(np.linalg.det(R))[:, None, None]
    p = rng.normal(size=(5, 3))
    got = metrics.pose_rsme(R.astype(np.float32), p.astype(np.float32),
                            R, p + 0.1)
    ref = jmetrics.pose_rsme(R.astype(np.float32), p.astype(np.float32),
                             R, p + 0.1)
    assert all(g.dtype == torch.float64 for g in got)
    for g, r in zip(got, ref):
        assert abs(float(g) - float(r)) <= 1e-9 * max(abs(float(r)), 1e-12)
