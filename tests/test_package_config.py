"""Import-time configuration of the package, and bench.py's device gate."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import json, jax, cuddhelmholtz_tpu; print(json.dumps({"
    "'dir': jax.config.jax_compilation_cache_dir,"
    "'precision': jax.config.jax_default_matmul_precision}))"
)


def _import_probe(env_updates, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_updates, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_compile_cache_defaults_to_checkout():
    rec = _import_probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert rec["dir"] == os.path.join(REPO, ".jax_cache")
    assert rec["precision"] == "highest"


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "cache")
    rec = _import_probe({"JAX_COMPILATION_CACHE_DIR": want})
    assert rec["dir"] == want


def test_bench_refuses_cpu_only_run():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs a GPU" in p.stderr


def test_bench_require_gpu_gate():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit):
        bench.require_gpu()
