"""Shared helpers of the benchmark's tests. Imports neither jax nor the JAX
package, so the tests also run on the card's machine:

    python3 -m pytest -p no:cacheprovider portbench/tests -q
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (the benchmark on the card)")


def run_harness(*args: str, cwd: Path = ROOT, module: str = "portbench.run", env=None,
                timeout: int = 600) -> subprocess.CompletedProcess:
    """The harness in a fresh process from `cwd`, with the program's package
    on the path."""
    e = dict(os.environ, **(env or {}))
    e["PYTHONPATH"] = os.pathsep.join([str(cwd), str(ROOT)])
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=timeout)


def last_line(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
