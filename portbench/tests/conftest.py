"""Fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests``): a copy of the benchmark at test
sizes, and the ``card`` marker for the tests that need an NVIDIA GPU,
which decide in a fixture, never at import, whether one is there."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from portbench.tests import tiny


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.tiny_copy(str(tmp_path_factory.mktemp("tiny")))


def run_in(root: str, code: str, timeout: int = 900):
    """Run ``code`` in a fresh interpreter whose ``portbench`` is the one
    under ``root`` (the program from this checkout); (rc, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, tiny.REPO]),
               USE_FLAX="0")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr
