"""chip_smoke.py refuses to run without a GPU: non-zero exit, no result
line, and a message that names the missing GPU."""

import os
import shutil
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """From the checkout, and copied alone into an empty directory: a
    non-zero exit and no `ok` line; the checkout run names the missing
    GPU."""
    cwd = _ROOT
    if where == "alone":
        shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    res = _run(cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    if where == "checkout":
        assert "no GPU" in res.stderr
