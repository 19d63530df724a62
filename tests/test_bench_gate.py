"""bench.py measures on a GPU or not at all: without one it exits nonzero
and prints no result, instead of falling back to the CPU."""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_require_gpu_refuses_cpu():
    import bench
    with pytest.raises(SystemExit) as e:
        bench.require_gpu(jax)
    assert "needs a GPU" in str(e.value)


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                        capture_output=True, text=True, env=env, timeout=300)
    assert cp.returncode != 0
    assert cp.stdout.strip() == ""
    assert "needs a GPU" in cp.stderr
