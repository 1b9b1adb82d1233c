"""Partition-quality study for unstructured DDH (no reference analog).

The reference's DDH only runs on ``uniform_rect`` with its structured
16x16-DOF blocks (``DDH.cpp:333-356``); this framework generalises to
arbitrary element labels, so the PARTITIONER becomes a quality knob with no
upstream baseline.  This driver characterises it: for matched domain counts
it measures interface size (the substructured system dimension), lambda-GMRES
iteration counts, and solve time for

  * the structured partitioner (on a jittered structured mesh, where both
    partitioners apply and every subdomain has distinct geometry),
  * median coordinate bisection (the default),
  * cut-sweep coordinate bisection (``cut_sweep=7``: balanced candidate cuts
    scored by crossing-edge count -- cut edges ARE the lambda unknowns).

Run: ``python -m cuddhelmholtz_tpu.examples.partition_study [--nx 32]``.
Emits one JSON line per case.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..mesh.io import load_unstructured_square
from ..mesh.mesh2d import Mesh2D
from ..spaces.ensemble import coordinate_bisection_labels, structured_labels
from .drivers import run_ddh


def jittered_rect(nx: int, amp: float = 0.15, seed: int = 3) -> Mesh2D:
    """uniform_rect with interior vertices perturbed by ``amp`` cell widths:
    structured connectivity (so structured labels apply) but per-element
    geometry, the general-partition regime."""
    mesh0 = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    rng = np.random.default_rng(seed)
    verts = mesh0.vertices.copy()
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (
        np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12
    )
    verts[interior] += amp * (2.0 / nx) * rng.uniform(-1, 1, (int(interior.sum()), 2))
    return Mesh2D.from_vertices(verts, mesh0.elem_vertices)


def measure(name: str, mesh: Mesh2D, labels, nx: int, deg: int = 3, **kw) -> dict:
    t0 = time.perf_counter()
    r = run_ddh(
        nx=nx, deg=deg, mesh=mesh, element_labels=np.asarray(labels),
        m=20, maxit=100, tol=1e-4, transfer=True, **kw,
    )
    ddh = r.extra["ddh"]
    efem = ddh.efem
    rec = {
        "case": name,
        "n_elem": mesh.n_elem,
        "n_domains": int(ddh.n_domains),
        "n_shared": int(efem.n_shared_dofs),  # interface DOF pairs (cmap rows)
        "n_lambda": int(ddh.size),  # substructured system size (own-slot)
        "pad": int(ddh.pad),
        "max_dom_elems": int(np.max(efem.n_elems[: ddh.n_domains])),
        "min_dom_elems": int(np.min(efem.n_elems[: ddh.n_domains])),
        "restarts": int(r.num_iter),
        "matvecs": int(r.num_matvec),
        "success": bool(r.success),
        "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
        "solve_seconds": round(r.seconds, 3),
        "setup_seconds": round(r.extra["setup_seconds"], 2),
        "total_seconds": round(time.perf_counter() - t0, 2),
        "precompute": r.extra.get("precompute", {}),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32, help="jittered-mesh resolution")
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--sweep", type=int, default=7)
    ap.add_argument("--skip-unstructured", action="store_true")
    args = ap.parse_args(argv)
    recs = []

    if not args.skip_unstructured:
        # the 119-element fixture at its BASELINE config (8 domains)
        um = load_unstructured_square()
        for tag, labels in (
            ("unstr119_median8", coordinate_bisection_labels(um, 8)[0]),
            ("unstr119_sweep8", coordinate_bisection_labels(um, 8, cut_sweep=args.sweep)[0]),
        ):
            recs.append(measure(tag, um, labels, nx=8, deg=args.deg))

    # jittered structured mesh: all three partitioners at matched counts
    nx = args.nx
    jm = jittered_rect(nx)
    nb = args.deg + 1
    epd = 16 // nb  # the reference's 16-DOF blocks
    slab, ndom = structured_labels(nx, nx, epd, epd)
    recs.append(measure(f"jitter{nx}_structured{ndom}", jm, slab, nx=nx, deg=args.deg))
    for tag, labels in (
        (f"jitter{nx}_median{ndom}", coordinate_bisection_labels(jm, ndom)[0]),
        (
            f"jitter{nx}_sweep{ndom}",
            coordinate_bisection_labels(jm, ndom, cut_sweep=args.sweep)[0],
        ),
    ):
        recs.append(measure(tag, jm, labels, nx=nx, deg=args.deg))

    hdr = f"{'case':26s} {'ndom':>5s} {'n_shared':>8s} {'size':>7s} {'restarts':>8s} {'matvecs':>7s} {'secs':>7s}"
    print(hdr)
    for r in recs:
        print(
            f"{r['case']:26s} {r['n_domains']:5d} {r['n_shared']:8d} "
            f"{r['n_lambda']:7d} {r['restarts']:8d} {r['matvecs']:7d} "
            f"{r['solve_seconds']:7.2f}"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
