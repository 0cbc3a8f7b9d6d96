"""chip_smoke.py refuses to run without a GPU and without the repo."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _prints_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


def test_fails_without_gpu():
    r = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert not _prints_result(r.stdout)
    assert "no GPU" in r.stderr + r.stdout


def test_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script cannot import the package: non-zero exit, no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert not _prints_result(r.stdout)


def test_bench_fails_without_gpu():
    """bench.py measures a card; it never falls back to the CPU."""
    r = _run(os.path.join(REPO, "bench.py"), REPO)
    assert r.returncode != 0
    assert "measures a GPU" in r.stderr + r.stdout
    assert not r.stdout.strip()


def test_smoke_helpers():
    """chip_smoke's relative errors and tracer-mass sums."""
    import importlib.util

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    want = np.array([[3.0, -4.0]])
    l2, linf = cs.rel_err(want + np.array([[0.0, 0.5]]), want)
    assert (l2, linf) == (0.1, 0.125)

    class M:
        spheremp = np.full((2, 4, 4), 0.5)

    Q = np.ones((2, 3, 5, 4, 4))
    np.testing.assert_allclose(cs.tracer_mass(M, Q), [80.0] * 3)
