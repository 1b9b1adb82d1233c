"""Test configuration: run on a simulated 8-device CPU mesh with float64.

Tests exercise the same numerical oracles as the reference's test suite
(which runs in fp64 on the GPU).  The library runs its solves in fp32 on the
card, but correctness tests need fp64 and a multi-device mesh on any
machine, so the suite forces JAX's CPU backend with 8 virtual devices and
enables x64 before JAX initialises.

Tests marked ``gpu`` need an NVIDIA card: they run their work in a child
process on the GPU (``python -m pytest tests -m gpu`` on a machine with one)
and skip elsewhere.  The ``gpu_env`` fixture decides, at test time.
"""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; runs its work in a child process on the card"
    )


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU; skips the test
    when nvidia-smi finds no card."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env
