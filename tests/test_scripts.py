"""The measurement scripts refuse to measure without a GPU.

``chip_smoke.py`` and ``bench.py`` must exit non-zero and print no result
when JAX has no GPU, and ``chip_smoke.py`` must also fail where it stands
alone, without the package. On a machine with a card (``pytest -m gpu``)
the smoke test itself runs.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(args, cwd, env_extra=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    return bool(lines) and lines[-1].startswith("{")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_cpu(script):
    out = _run([script], ROOT, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert not _has_result(out.stdout)
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert not _has_result(out.stdout)


@pytest.fixture
def gpu():
    """Skips unless this machine has an NVIDIA card (decided here, at test
    time, never while the module is imported)."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke test on the card, in a child process that JAX runs
    on the GPU (this test process stays on the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
