"""Scaling harness: DDH matvec throughput over a growing device mesh.

BASELINE.json's scaling protocol: operator-apply nnz/s at 1 chip / 1 host /
N >= 2 hosts with >= 70% weak-scaling efficiency.  This harness runs the
subdomain-sharded DDH apply (``parallel.ShardedDDH``) on meshes of
1, 2, 4, ... devices and reports per-mesh matvec time and efficiency.

* **Weak scaling** (default): the subdomain grid grows with the mesh
  (nx = base_nx * sqrt(n_devices) rounded to a subdomain multiple), so each
  device keeps ~constant work.
* **Strong scaling** (--strong): fixed problem, more devices.

On the GPUs of one host this measures the sharded throughput; on a
simulated CPU mesh (``--cpu N``) it only validates the sharded path (CPU
timings are not device metrics).

Usage:  python -m cuddhelmholtz_tpu.examples.scaling [--strong] [--transfer]
        [--global] [--cpu N] [base_nx]

``--transfer`` precomputes the per-subdomain trace-transfer matrices and
shards those, so each matvec is one small per-chip matmul + psum (the
production configuration; throughput is still reported in wave-cycle
stencil-equivalent nnz/s, matching bench.py's effective metric).
``--global`` measures the element-sharded coupled Helmholtz matvec
(``parallel.sharded_helmholtz_matvec``) instead of the DDH apply -- the
global-system half of BASELINE config 5.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def force_cpu_mesh(n_devices: int) -> None:
    """Make JAX's backend an n-device simulated CPU platform (call before
    any other JAX work in the process)."""
    import jax

    try:
        jax.config.update("jax_num_cpu_devices", n_devices)
    except RuntimeError:
        pass  # backends already initialised
    if len(jax.devices()) < n_devices:
        jax.config.update("jax_platforms", "cpu")
        import jax.extend.backend as _xb

        _xb.clear_backends()


def scaling_global(base_nx: int = 32, strong: bool = False, deg: int = 3, reps: int = 5):
    """Element-sharded coupled-Helmholtz matvec throughput over the mesh."""
    import jax
    import jax.numpy as jnp

    from ..mesh.mesh2d import Mesh2D
    from ..models.helmholtz import make_helmholtz_op, project_coefficients
    from ..parallel.sharding import device_mesh, sharded_helmholtz_matvec
    from ..spaces.h1 import FaceSpace, H1Space
    from ..utils.basis import Basis

    n_total = len(jax.devices())
    sizes = []
    n = 1
    while n <= n_total:
        sizes.append(n)
        n *= 2

    nb = deg + 1
    records = []
    base_per_dev = None
    for nd in sizes:
        nx = base_nx if strong else int(round(base_nx * np.sqrt(nd)))
        mesh2d = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        fem = H1Space(mesh2d, Basis(nb))
        fs = FaceSpace(fem, mesh2d.boundary_edges)
        omega = 2 * np.pi * nx / 10

        def coeff(xy):
            r = xy[..., 0] ** 2 + xy[..., 1] ** 2
            return jnp.where(r < 0.0625, 0.2, 1.0)

        a2, af = project_coefficients(fem, fs, coeff, dtype=jnp.float32)
        op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=jnp.float32, kron=False)
        matvec = jax.jit(sharded_helmholtz_matvec(op, device_mesh(nd)))
        U = jnp.zeros(2 * fem.ndof, jnp.float32).at[0].set(1.0)
        matvec(U).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            y = matvec(U)
        y.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        # stencil-equivalent nnz: 2 stiffness + 2 mass applies on ndof rows
        nnz = 4 * fem.ndof * (2 * nb - 1) ** 2
        per_dev = nnz / dt / nd
        if base_per_dev is None:
            base_per_dev = per_dev
        rec = {
            "devices": nd,
            "nx": nx,
            "ndof": fem.ndof,
            "matvec_seconds": dt,
            "nnz_per_s": nnz / dt,
            "nnz_per_s_per_device": per_dev,
            "efficiency_vs_1dev": per_dev / base_per_dev,
        }
        records.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    return records


def scaling(
    base_nx: int = 32,
    strong: bool = False,
    deg: int = 3,
    reps: int = 3,
    transfer: bool = False,
):
    import jax
    import jax.numpy as jnp

    from ..mesh.mesh2d import Mesh2D
    from ..parallel.sharding import ShardedDDH, device_mesh
    from ..solvers.ddh import DDH
    from ..spaces.h1 import H1Space
    from ..utils.basis import Basis

    n_total = len(jax.devices())
    sizes = []
    n = 1
    while n <= n_total:
        sizes.append(n)
        n *= 2

    nb = deg + 1
    epd = 16 // nb  # elements per subdomain side (reference DDH_BLOCK_SIZE=16)
    records = []
    base_per_dev = None
    for nd in sizes:
        if strong:
            nx = base_nx
        else:
            # weak scaling: total subdomains ~ proportional to devices
            nx = int(round(base_nx * np.sqrt(nd) / epd)) * epd
        mesh2d = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        fem = H1Space(mesh2d, Basis(nb))
        omega = 2 * np.pi * nx / 10
        ddh = DDH(omega, np.ones(fem.ndof), fem, nx=nx, ny=nx)
        if transfer:
            ddh.precompute_transfer()
        dmesh = device_mesh(nd)
        sddh = ShardedDDH(ddh, dmesh)
        lam = jnp.zeros(sddh.size, jnp.float32).at[0].set(1.0)
        sddh.action(lam).block_until_ready()  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            y = sddh.action(lam)
        y.block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        nnz = (
            ddh.wh_maxit
            * ddh.nt
            * 2
            * int(ddh.efem.sizes.astype(np.int64).sum())
            * (2 * nb - 1) ** 2
        )
        per_dev = nnz / dt / nd
        if base_per_dev is None:
            base_per_dev = per_dev
        rec = {
            "devices": nd,
            "nx": nx,
            "n_domains": ddh.n_domains,
            "matvec_seconds": dt,
            "nnz_per_s": nnz / dt,
            "nnz_per_s_per_device": per_dev,
            "efficiency_vs_1dev": per_dev / base_per_dev,
        }
        records.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    return records


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    strong = "--strong" in args
    transfer = "--transfer" in args
    global_ = "--global" in args
    args = [a for a in args if a not in ("--strong", "--transfer", "--global")]
    if "--cpu" in args:
        i = args.index("--cpu")
        force_cpu_mesh(int(args[i + 1]))
        del args[i : i + 2]
    base_nx = int(args[0]) if args else 32
    if global_:
        out = scaling_global(base_nx=base_nx, strong=strong)
    else:
        out = scaling(base_nx=base_nx, strong=strong, transfer=transfer)
    print(json.dumps(out))
