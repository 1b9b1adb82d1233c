"""``chip_smoke.py``: its refusal off the card, its output contract, and its
phase functions at tiny sizes on the CPU (the full sizes run on the GPU)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None):
    env = dict(os.environ if env is None else env)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_ok_line(stdout):
    return any('"ok": true' in line for line in stdout.splitlines())


def test_refuses_cpu_only_run():
    p = _run([], REPO)
    assert p.returncode != 0
    assert not _has_ok_line(p.stdout)
    assert "JAX found no GPU" in p.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run([], str(tmp_path), env)
    assert p.returncode != 0
    assert not _has_ok_line(p.stdout)


def test_rejects_unknown_arguments(capsys):
    assert chip_smoke.main(["--bogus"]) == 2
    assert not _has_ok_line(capsys.readouterr().out)


@pytest.mark.parametrize(
    "argv, children, count",
    [([], ["fp32", "fp64"], 1), (["--four-cards"], ["four"], 4)],
)
def test_parent_runs_children_in_turn_and_prints_contract(
    monkeypatch, capsys, argv, children, count
):
    """Children run one after the other; the card line precedes the last
    line, which is exactly the ok/device object."""
    ran = []
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}

    def fake_child(which, smi, deadline):
        ran.append(which)
        return 0, dict(dev, phase="device", nvidia_smi=smi)

    monkeypatch.setattr(chip_smoke, "run_child", fake_child)
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert chip_smoke.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert ran == children
    assert lines[-2] == "card: NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": dev}


def test_parent_stops_at_first_failed_child(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: None)
    monkeypatch.setattr(
        chip_smoke, "run_child", lambda w, s, d: (ran.append(w), (1, None))[1]
    )
    assert chip_smoke.main([]) == 1
    assert ran == ["fp32"]
    assert not _has_ok_line(capsys.readouterr().out)


def test_phase_device_requires_gpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.phase_device("NVIDIA H100 80GB HBM3, 700.00 W")
    rec = chip_smoke.phase_device(None, require_gpu=False)
    assert rec["platform"] == "cpu" and rec["count"] == 8
    assert rec["default_matmul_precision"] == "highest"
    with pytest.raises(chip_smoke.SmokeFailure, match="need 16 devices"):
        chip_smoke.phase_device(None, want_count=16, require_gpu=False)


def test_phase_precision_small():
    rec = chip_smoke.phase_precision(n=192)
    errs = rec["rel_err"]
    assert set(errs) == {"default", "high", "highest"}
    assert errs["highest"] < 1e-5


def test_phase_wave_cycle_small():
    rec = chip_smoke.phase_wave_cycle(nx=16, n_doms=4)
    assert rec["err_u"] <= 2e-4 and rec["err_v"] <= 2e-4
    assert rec["pad"] == 256 and len(rec["domains"]) >= 4


def test_phase_flagship_small():
    rec = chip_smoke.phase_flagship(restarts=None, n_rep=1, nx=16)
    assert rec["success"] and rec["transfer_vs_direct"] <= 1e-4
    assert rec["prepare"]["transfer_nu"] >= 1
    assert rec["wave_cycle_ms"] > 0 and rec["warm_seconds"] > 0


def test_phase_flagship_restart_window():
    with pytest.raises(chip_smoke.SmokeFailure, match="restarts"):
        chip_smoke.phase_flagship(restarts=(90, 100), n_rep=1, nx=8)


def test_phase_composite_small():
    rec = chip_smoke.phase_composite(nx=8, tol=1e-6)
    assert rec["final_rel_res"] <= 1e-6 and rec["stagnated"] is False
    assert rec["refine_steps"] >= 1


def test_phase_four_cards_small():
    """The four-card comparison on four of the CPU mesh's virtual devices."""
    rec = chip_smoke.phase_four_cards(n=4, nx=16)
    assert rec["action_rel_err"] <= 1e-5
    assert rec["gmres"]["sharded"]["restarts"] == rec["gmres"]["single"]["restarts"]
    assert rec["mesh_shape"] == {"shard": 4}


@pytest.mark.gpu
def test_precision_and_wave_cycle_on_gpu(gpu_env):
    code = (
        "import chip_smoke as c; c.phase_device(c.nvidia_smi());"
        "c.phase_precision(); c.phase_wave_cycle()"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=gpu_env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["phase"] == "wave_cycle" and np.isfinite(rec["err_u"])
