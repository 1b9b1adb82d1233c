"""Smoke run of the DDH Helmholtz solver on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --four-cards  # ShardedDDH over four cards, nothing else

Drives the main path through the entry points a user calls (``DDH``,
``DDH.prepare``, ``DDH.solver`` and ``examples.drivers.run_config`` on the
``config.BASELINE_CONFIGS`` rows) at the reference's full configuration, and
checks every phase against its tolerance:

  1. device: JAX must report a GPU; prints the card as nvidia-smi reads it;
  2. precision probe: one 4096^2 fp32 matmul per precision word vs NumPy fp64;
  3. the XLA wave cycle at flagship width vs the NumPy reference cycle;
  4. the flagship lambda-solve (``ddh_structured``), and the transfer action
     against the direct wave-cycle action;
  5. the scale row ``ddh_512_block32``;
  6. the unstructured square ``ddh_unstructured_square``;
  7. the composite fp64 solve ``helmholtz_ddh_1e6``.

This parent process never imports JAX.  Phases 1-6 run in one child process
and phase 7 (x64 is fixed at import) in a second child started after the
first has exited, so one JAX process holds the card at a time.  Each phase
prints one JSON line.  The last line of a run where every phase passed is
``{"ok": true, "device": {...}}``; any failure exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIME_LIMIT = 1150.0  # seconds for all children together


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **rec) -> dict:
    rec = {"phase": phase, **rec}
    print(json.dumps(rec, default=float), flush=True)
    return rec


def nvidia_smi() -> str | None:
    """``name, power.limit`` of the card as nvidia-smi prints them (None when
    nvidia-smi is missing or fails)."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    out = p.stdout.strip()
    return out if p.returncode == 0 and out else None


# ------------------------------------------------------------------ phases


def phase_device(smi: str | None, want_count: int = 1, require_gpu: bool = True) -> dict:
    import jax

    import cuddhelmholtz_tpu
    from cuddhelmholtz_tpu import native

    devs = jax.devices()
    d0 = devs[0]
    rec = {
        "platform": d0.platform,
        "kind": d0.device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
        "default_matmul_precision": jax.config.jax_default_matmul_precision,
        "x64": bool(jax.config.jax_enable_x64),
        "native_topology": native.available(),
        "package": os.path.dirname(cuddhelmholtz_tpu.__file__),
    }
    if require_gpu:
        check(d0.platform == "gpu", f"JAX found no GPU (platform {d0.platform!r})")
        check(smi is not None, "nvidia-smi did not report the card")
    check(len(devs) >= want_count, f"need {want_count} devices, found {len(devs)}")
    return emit("device", **rec)


def phase_precision(n: int = 4096) -> dict:
    """Relative Frobenius error of one (n, n) fp32 matmul at each precision
    word against NumPy fp64: what each word lowers to on this device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    da, db = jnp.asarray(a), jnp.asarray(b)
    errs = {}
    for word in ("default", "high", "highest"):
        f = jax.jit(lambda x, y, w=word: jnp.matmul(x, y, precision=w))
        got = np.asarray(f(da, db), np.float64)
        errs[word] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(errs["highest"] < 1e-5, f"'highest' is not true fp32: {errs['highest']:.2e}")
    return emit("precision", n=n, rel_err=errs)


def _flagship_ddh(nx: int, deg: int = 3, block_size: int = 16):
    """The flagship's DDH, built exactly as ``run_ddh`` builds it."""
    import numpy as np

    from cuddhelmholtz_tpu.examples.drivers import _setup_scope, wave_speed_coeff
    from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu.ops.functional import linear_functional
    from cuddhelmholtz_tpu.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu.solvers.ddh import DDH
    from cuddhelmholtz_tpu.spaces.h1 import H1Space
    from cuddhelmholtz_tpu.utils.basis import Basis

    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    with _setup_scope():
        b_a = linear_functional(fem, wave_speed_coeff)
        a_nodal = np.asarray(apply_diag_inv_mass(make_diag_inv_mass_op(fem), b_a))
    return omega, a_nodal, fem, DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=block_size)


def phase_wave_cycle(nx: int = 128, n_doms: int = 8, tol: float = 2e-4) -> dict:
    """``_wave_cycle_xla`` at the flagship's width on real subdomains (spread
    over the grid, the disc's centre included) vs the NumPy reference."""
    import numpy as np

    from cuddhelmholtz_tpu.solvers.ddh import PRECISION
    from cuddhelmholtz_tpu.solvers.ddh_oracle import DDHOracle, compare_wave_cycle

    t0 = time.perf_counter()
    omega, a_nodal, fem, ddh = _flagship_ddh(nx)
    oracle = DDHOracle(omega, a_nodal, fem, ddh.efem)
    check(oracle.nt == ddh.nt, "oracle and DDH time grids differ")
    nd = ddh.n_domains
    side = int(round(np.sqrt(nd)))
    doms = sorted(set(np.linspace(0, nd - 1, n_doms - 1).astype(int).tolist())
                  | {(side // 2) * side + side // 2})
    t1 = time.perf_counter()
    err_u, err_v, _ = compare_wave_cycle(ddh, oracle, doms)
    rec = emit(
        "wave_cycle", nx=nx, pad=ddh.pad, nt=ddh.nt, wh_maxit=ddh.wh_maxit,
        precision=PRECISION, domains=doms, setup_seconds=t1 - t0,
        cycle_seconds=time.perf_counter() - t1, err_u=err_u, err_v=err_v, tol=tol,
    )
    check(err_u <= tol and err_v <= tol, f"wave cycle vs reference: {err_u:.2e}, {err_v:.2e}")
    return rec


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _row(name: str, **overrides):
    from cuddhelmholtz_tpu.config import BASELINE_CONFIGS
    from cuddhelmholtz_tpu.examples.drivers import run_config

    cfg = {c.name: c for c in BASELINE_CONFIGS}[name]
    t0 = time.perf_counter()
    r = run_config(cfg, **overrides)
    total = time.perf_counter() - t0
    pre = r.extra.get("precompute", {})
    rec = {
        "success": bool(r.success),
        "restarts": int(r.num_iter),
        "matvecs": int(r.num_matvec),
        "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
        "first_solve_seconds": r.seconds,
        "total_seconds": total,
        "peak_bytes_in_use": _peak_bytes(),
    }
    for k in ("ndof", "n_domains", "nt", "setup_seconds", "warm_seconds",
              "compile_seconds", "refine_steps", "stagnated"):
        if k in r.extra:
            rec[k] = r.extra[k]
    if pre:
        rec["prepare"] = {
            k: pre[k]
            for k in ("cache_hit", "transfer_nu", "transfer_seconds", "io_seconds",
                      "load_seconds")
            if k in pre
        }
    return r, rec


def phase_flagship(restarts=(16, 20), n_rep: int = 5, tol: float = 1e-4, **overrides) -> dict:
    """``ddh_structured`` through ``run_config``; then the transfer action
    against the direct wave-cycle action on one random lambda, and the time
    of one executed wave cycle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    r, rec = _row("ddh_structured", measure_warm=True, **overrides)
    ddh = r.extra["ddh"]
    lam = jnp.asarray(np.random.default_rng(1).standard_normal(ddh.size).astype(np.float32))
    y_t = np.asarray(ddh.action(lam))
    ddh.use_transfer = False
    try:
        y_d = jax.block_until_ready(ddh.action(lam))  # compiles the cycle
        t0 = time.perf_counter()
        y = lam
        for _ in range(n_rep):
            y = ddh.action(y)
        jax.block_until_ready(y)
        cycle_ms = (time.perf_counter() - t0) / n_rep * 1e3
    finally:
        ddh.use_transfer = True
    y_d = np.asarray(y_d)
    rel = float(np.linalg.norm(y_t - y_d) / np.linalg.norm(y_d))
    rec = emit("flagship", **rec, transfer_vs_direct=rel, wave_cycle_ms=cycle_ms,
               peak_bytes_after_cycle=_peak_bytes())
    check(rec["success"], "flagship lambda-solve did not converge")
    if restarts is not None:
        lo, hi = restarts
        check(lo <= rec["restarts"] <= hi, f"flagship restarts {rec['restarts']} not in [{lo}, {hi}]")
    check(rel <= tol, f"transfer vs direct action: {rel:.2e}")
    return rec


def phase_row(name: str, **overrides) -> dict:
    r, rec = _row(name, measure_warm=True, **overrides)
    rec = emit(name, **rec)
    check(rec["success"], f"{name} did not converge")
    return rec


def phase_composite(tol: float = 1e-6, **overrides) -> dict:
    """``helmholtz_ddh_1e6``: fp64 true residual <= tol, no stagnation."""
    import jax

    import cuddhelmholtz_tpu  # noqa: F401  (applies CUDDH_X64 at import)

    check(jax.config.jax_enable_x64, "the composite phase needs CUDDH_X64=1")
    r, rec = _row("helmholtz_ddh_1e6", **overrides)
    rec = emit("helmholtz_ddh_1e6", **rec)
    check(rec["final_rel_res"] <= tol, f"fp64 true residual {rec['final_rel_res']:.2e} > {tol}")
    check(not rec.get("stagnated", False), "refinement stagnated")
    return rec


def phase_four_cards(n: int = 4, nx: int = 128, tol: float = 1e-5, **overrides) -> dict:
    """``ShardedDDH`` of the flagship over a 1-D mesh of ``n`` devices vs the
    single-device DDH: the action on one random lambda, and the restart
    count of the lambda-GMRES on the same right-hand side."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cuddhelmholtz_tpu.parallel.sharding import ShardedDDH, device_mesh
    from cuddhelmholtz_tpu.solvers.gmres import gmres

    check(len(jax.devices()) >= n, f"need {n} devices, found {len(jax.devices())}")
    r, rec = _row("ddh_structured", nx=nx, **overrides)
    ddh = r.extra["ddh"]
    sddh = ShardedDDH(ddh, device_mesh(n))
    lam = jnp.asarray(np.random.default_rng(1).standard_normal(ddh.size).astype(np.float32))
    y1 = np.asarray(ddh.action(lam))
    yn = np.asarray(sddh.action(lam))
    rel = float(np.linalg.norm(yn - y1) / np.linalg.norm(y1))

    from cuddhelmholtz_tpu.config import BASELINE_CONFIGS
    from cuddhelmholtz_tpu.examples.drivers import point_sources
    from cuddhelmholtz_tpu.models.helmholtz import helmholtz_rhs

    g = {c.name: c for c in BASELINE_CONFIGS}["ddh_structured"].gmres
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, ddh.omega))
    Y = ddh.rhs(jnp.asarray(b, jnp.float32))
    outs = {}
    for key, op in (("single", ddh.action), ("sharded", sddh.action)):
        t0 = time.perf_counter()
        o = jax.block_until_ready(jax.jit(lambda y: gmres(op, y, m=g.m, maxit=g.maxit, tol=g.tol))(Y))
        outs[key] = {"restarts": int(o.num_iter), "matvecs": int(o.num_matvec),
                     "success": bool(o.success), "seconds": time.perf_counter() - t0}
    rec = emit("four_cards", n_devices=n, mesh_shape=dict(sddh.mesh.shape),
               rolled=sddh._roll_data is not None, action_rel_err=rel, tol=tol,
               gmres=outs, row=rec)
    check(rel <= tol, f"sharded vs single-device action: {rel:.2e}")
    check(outs["sharded"]["success"] and outs["single"]["success"], "lambda-GMRES failed")
    check(outs["sharded"]["restarts"] == outs["single"]["restarts"], "restart counts differ")
    return rec


# ----------------------------------------------------------------- drivers


def child_main(which: str) -> int:
    smi = os.environ.get("CHIP_SMOKE_SMI") or None
    try:
        if which == "four":
            phase_device(smi, want_count=4)
            phase_four_cards()
        elif which == "fp64":
            phase_device(smi)
            phase_composite()
        else:
            phase_device(smi)
            phase_precision()
            phase_wave_cycle()
            phase_flagship()
            phase_row("ddh_512_block32")
            phase_row("ddh_unstructured_square")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


def run_child(which: str, smi: str | None, deadline: float) -> tuple[int, dict | None]:
    """Run one child, echo its stdout, return (rc, its device record)."""
    import threading

    env = dict(os.environ, CHIP_SMOKE_SMI=smi or "")
    if which == "fp64":
        env["CUDDH_X64"] = "1"
    p = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--child", which],
        cwd=HERE, env=env, stdout=subprocess.PIPE, text=True,
    )
    device = {}

    def pump():
        for line in p.stdout:
            print(line, end="", flush=True)
            if line.startswith('{"phase": "device"'):
                device.update(json.loads(line))

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print(f"chip_smoke: child {which} ran out of time", file=sys.stderr, flush=True)
        p.kill()
        p.wait()
        rc = 124
    reader.join(timeout=10)
    return rc, device or None


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        return child_main(argv[1])
    if argv not in ([], ["--four-cards"]):
        print(__doc__, file=sys.stderr)
        return 2
    children = ["four"] if argv else ["fp32", "fp64"]
    smi = nvidia_smi()
    deadline = time.monotonic() + TIME_LIMIT
    device = None
    for which in children:
        rc, dev = run_child(which, smi, deadline)
        if rc != 0:
            print(f"chip_smoke: child {which} exited with {rc}", file=sys.stderr, flush=True)
            return 1
        device = device or dev
    print(f"card: {smi}", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": device["platform"], "kind": device["kind"],
                   "count": device["count"]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
