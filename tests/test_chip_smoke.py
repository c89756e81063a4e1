"""chip_smoke.py refuses to report a result anywhere but on the GPU, and
outside a checkout of the repo."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# Stands in for a GPU backend so the script gets past its device check.
_FAKE_GPU = ("import runpy, sys, jax; jax.default_backend = lambda: 'gpu'; "
             "sys.argv = ['chip_smoke.py']; "
             "runpy.run_path('chip_smoke.py', run_name='__main__')")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _assert_no_result(out):
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_refuses_on_cpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    _assert_no_result(out)
    assert "no GPU" in out.stderr


@pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
def test_refuses_alone_in_a_directory(tmp_path, argv):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py", *argv],
                         cwd=tmp_path, env=_env(), capture_output=True,
                         text=True, timeout=120)
    _assert_no_result(out)


def test_refuses_alone_even_past_the_device_check(tmp_path):
    """With the device check passed, a directory holding only the script
    still fails: the package is not there to import."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "-c", _FAKE_GPU], cwd=tmp_path,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    _assert_no_result(out)
    assert "No module named 'nbody_tpu'" in out.stderr
