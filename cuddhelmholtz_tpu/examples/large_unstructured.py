"""Large genuinely-unstructured DDH benchmark.

Stresses the places the toy fixtures never could: the
coordinate-bisection partitioner's balance, per-domain stiffness dedup and
grouping, the per-domain wave cycle probes, and the roll-route discovery --
at thousands of elements and hundreds of truly irregular subdomains.  The
reference cannot run ANY of this: its DDH requires ``uniform_rect``
(``/root/reference/source/DDH.cpp:333-344``).

Pipeline: refine the 119-element unstructured-square fixture ``levels``
times (4x elements per level, irregular topology preserved), pick omega for
~5 elements per wavelength (the flagship's resolution), partition with
median coordinate bisection, run the lambda-solve to 1e-4 (and optionally
the composite 1e-6 solve), and repeat on a matched jittered-grid control.

Usage:
  python -m cuddhelmholtz_tpu.examples.large_unstructured \
      [--levels 3] [--domains 256] [--deg 3] [--composite] [--control]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_h(mesh) -> float:
    v = mesh.vertices[mesh.elem_vertices]
    x, y = v[..., 0], v[..., 1]
    area = 0.5 * np.abs(
        np.sum(x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1)
    )
    return float(np.sqrt(np.median(area)))


def run_case(name: str, mesh, n_domains: int, deg: int, omega: float,
             tol: float, composite: bool, coarse: str | None = None,
             coarse_n_dir: int = 4, coarse_dps: int = 4) -> dict:
    import jax
    import jax.numpy as jnp

    from ..examples.drivers import (
        _setup_scope, _want_io_maps, point_sources, wave_speed_coeff,
    )
    from ..models.helmholtz import helmholtz_rhs
    from ..ops.functional import linear_functional
    from ..ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from ..solvers.ddh import DDH
    from ..spaces.ensemble import coordinate_bisection_labels
    from ..spaces.h1 import H1Space
    from ..utils.basis import Basis

    labels, ndom = coordinate_bisection_labels(mesh, n_domains)
    counts = np.bincount(labels, minlength=ndom)
    fem = H1Space(mesh, Basis(deg + 1))
    rec = {
        "case": name,
        "n_elem": int(mesh.n_elem),
        "ndof": int(fem.ndof),
        "omega": float(omega),
        "n_domains": int(ndom),
        "elems_per_domain": [int(counts.min()), int(counts.max())],
    }
    log(f"[{name}] nel={mesh.n_elem} ndof={fem.ndof} omega={omega:.1f} "
        f"ndom={ndom} balance={counts.min()}-{counts.max()}")

    with _setup_scope():
        b_a = linear_functional(fem, wave_speed_coeff)
        mi = make_diag_inv_mass_op(fem)
        a_nodal = np.asarray(apply_diag_inv_mass(mi, b_a))
        b = np.asarray(helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)))

    t0 = time.perf_counter()
    ddh = DDH(omega, a_nodal, fem, element_labels=labels, n_domains=ndom)
    rec["ctor_seconds"] = time.perf_counter() - t0
    rec.update(
        n_lambda=int(ddh.size), nt=int(ddh.nt), pad=int(ddh.pad),
        shared_S=bool(ddh.shared_S),
    )
    t0 = time.perf_counter()
    pstats = ddh.prepare(want_io=_want_io_maps())
    rec["prepare_seconds"] = time.perf_counter() - t0
    rec["prepare"] = {
        k: v for k, v in pstats.items() if not isinstance(v, (list, dict))
    }
    rec["transfer_nu"] = ddh.transfer_stats.get("transfer_nu")
    rec["roll_routes"] = len(ddh.route_offs) if ddh.route is not None else 0
    log(f"[{name}] ctor {rec['ctor_seconds']:.1f}s prepare "
        f"{rec['prepare_seconds']:.1f}s nt={ddh.nt} pad={ddh.pad} "
        f"nu={rec['transfer_nu']} routes={rec['roll_routes']} "
        f"hit={pstats.get('cache_hit')}")

    if coarse:
        t0 = time.perf_counter()
        cs = ddh.make_coarse(
            n_dir=coarse_n_dir, domains_per_super=coarse_dps,
            method="iterative", solve_m=20, solve_maxit=2, solve_tol=3e-2,
        )
        rec["coarse"] = {
            "mode": coarse, "n_dir": coarse_n_dir, "dps": coarse_dps,
            "nc": int(2 * cs.nbr.shape[0] * cs.V.shape[2]),
            "build_seconds": time.perf_counter() - t0,
        }
        log(f"[{name}] coarse space: {rec['coarse']}")

    solve = ddh.solver(20, 100, tol, coarse=coarse)
    bj = jnp.asarray(b, jnp.float32)
    t0 = time.perf_counter()
    out, U = solve(bj)
    U.block_until_ready()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, U = solve(bj)
    U.block_until_ready()
    warm = time.perf_counter() - t0
    rec.update(
        restarts=int(out.num_iter), matvecs=int(out.num_matvec),
        success=bool(out.success), solve_seconds=warm,
        compile_seconds=first - warm,
        final_rel_res=float(
            np.asarray(out.res_norm)[int(out.n_hist) - 1]
            / np.asarray(out.res_norm)[0]
        ),
    )
    log(f"[{name}] lambda-solve: {rec['restarts']} restarts / "
        f"{rec['matvecs']} matvecs, warm {warm:.2f}s "
        f"(compile {first - warm:.0f}s) success={rec['success']}")

    if composite:
        from ..examples.drivers import run_helmholtz_ddh

        r = run_helmholtz_ddh(
            nx=1, deg=deg, m=20, maxit=100, tol=1e-6, mesh=mesh,
            element_labels=labels, n_domains=ndom, omega=omega,
        )
        rec["composite"] = {
            "success": bool(r.success),
            "iters": int(r.num_iter),
            "matvecs": int(r.num_matvec),
            "warm_seconds": r.extra.get("warm_seconds"),
            "refine_steps": r.extra.get("refine_steps"),
            "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
        }
        log(f"[{name}] composite 1e-6: {rec['composite']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--domains", type=int, default=256)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--elems-per-wavelength", type=float, default=5.0)
    ap.add_argument("--omega-scale", type=float, default=1.0,
                    help="multiply omega (frequency-stress axis: x2 halves "
                         "elements per wavelength)")
    ap.add_argument("--coarse", default=None,
                    choices=["additive", "multiplicative"],
                    help="two-level correction (iterative block-sparse space)")
    ap.add_argument("--coarse-n-dir", type=int, default=4)
    ap.add_argument("--coarse-dps", type=int, default=4)
    ap.add_argument("--composite", action="store_true",
                    help="also run the coupled 1e-6 solve (needs CUDDH_X64=1)")
    ap.add_argument("--control", action="store_true",
                    help="also run the matched jittered-grid control case")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    from ..mesh.io import load_unstructured_square
    from ..mesh.refine import jittered_grid, refine_quad_mesh

    mesh = refine_quad_mesh(load_unstructured_square(), args.levels)
    h = median_h(mesh)
    omega = args.omega_scale * 2 * np.pi / (args.elems_per_wavelength * h)
    tag = f"unstructured_L{args.levels}"
    if args.omega_scale != 1.0:
        tag += f"_w{args.omega_scale:g}"
    if args.coarse:
        tag += f"_coarse_{args.coarse[:4]}"
    recs = [run_case(
        tag, mesh, args.domains, args.deg, omega,
        args.tol, args.composite, coarse=args.coarse,
        coarse_n_dir=args.coarse_n_dir, coarse_dps=args.coarse_dps,
    )]

    if args.control:
        nxj = int(round(np.sqrt(mesh.n_elem)))
        ctrl = jittered_grid(nxj, nxj, amount=0.25, seed=1)
        recs.append(run_case(
            f"jittered_{nxj}x{nxj}", ctrl, args.domains, args.deg, omega,
            args.tol, args.composite,
        ))

    for r in recs:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
