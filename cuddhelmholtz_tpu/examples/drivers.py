"""Example drivers reproducing the reference's shipped configurations.

Parity with ``/root/reference/examples/{Poisson,Helmholtz,DDH}.cpp``: same
meshes, forcings, coefficients, solver budgets, and binary output formats
(``xy.0000`` coordinates and raw float64 solution dumps readable with
``numpy.fromfile``).  Each driver is a plain function so benchmarks and tests
can run reduced configurations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.io import to_file
from ..mesh.mesh2d import Mesh2D
from ..models.helmholtz import (
    apply_helmholtz,
    helmholtz_rhs,
    make_helmholtz_op,
    project_coefficients,
)
from ..models.poisson import solve_poisson
from ..ops.functional import linear_functional
from ..ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from ..solvers.ddh import DDH
from ..solvers.gmres import gmres
from ..spaces.h1 import FaceSpace, H1Space
from ..utils.basis import Basis


def _require_x64(dtype) -> None:
    """Fail fast when float64 is requested without x64 enabled.

    JAX's x64 mode is process-global and must be decided before the first
    trace (arrays and programs made before a mid-process flip keep the old
    dtypes).  The package therefore never flips the flag itself: set
    ``CUDDH_X64=1`` in the environment (honored at package import) or call
    ``jax.config.update('jax_enable_x64', True)`` before importing.  See
    docs/DTYPES.md."""
    if jnp.dtype(dtype) == jnp.dtype("float64") and not jax.config.jax_enable_x64:
        raise RuntimeError(
            "float64 requested but jax x64 mode is off. Set CUDDH_X64=1 in the "
            "environment (or enable jax_enable_x64 before importing) -- the "
            "package does not flip the flag mid-process (docs/DTYPES.md)."
        )


def _setup_scope():
    """Run setup-time functionals (host-side problem setup, evaluated
    eagerly op by op) on the CPU device: on the accelerator every eager op
    shape would be one more small compile."""
    import contextlib

    try:
        cpus = jax.devices("cpu")
    except RuntimeError:
        return contextlib.nullcontext()
    return jax.default_device(cpus[0])


def _want_io_maps() -> bool:
    """Precompute the rhs/postprocess linear maps on accelerator backends
    (where the probe cycles are cheap and every solve reuses them); on CPU
    the probes cost more than they save, so require CUDDH_IO_MAPS=1."""
    import os

    v = os.environ.get("CUDDH_IO_MAPS")
    if v is not None:
        return v not in ("0", "false", "")
    return jax.default_backend() != "cpu"


def write_history(path: str, res_norm, times=None) -> None:
    """Write the per-restart residual history in the reference's text format
    (``res_norm time`` per line, scientific notation; Helmholtz.cpp:165-171).

    ``times`` is the per-restart wall-clock list from ``gmres_host``; jitted
    solves have no per-restart clock, so the column is written as ``nan``.
    """
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fout:
        for i, r in enumerate(np.asarray(res_norm)):
            t = times[i] if times is not None and i < len(times) else float("nan")
            fout.write(f"{r:.10e} {t:.10e}\n")


def point_sources(xy, omega):
    """The reference's two-Gaussian forcing (Helmholtz.cpp:72-83)."""
    s = omega * omega
    x, y = xy[..., 0], xy[..., 1]
    r1 = (x + 0.5) ** 2 + y**2
    r2 = (x - 0.5) ** 2 + (y + 0.5) ** 2
    return s / np.pi * (jnp.exp(-s * r1) + jnp.exp(-s * r2))


def wave_speed_coeff(xy):
    """a(x) = 1/c(x): 0.2 inside the r=0.25 disc (Helmholtz.cpp:85-94)."""
    r = xy[..., 0] ** 2 + xy[..., 1] ** 2
    return jnp.where(r < 0.0625, 0.2, 1.0)


@dataclass
class DriverResult:
    solution: np.ndarray
    coords: np.ndarray
    res_norm: np.ndarray
    num_iter: int
    num_matvec: int
    seconds: float
    success: bool
    extra: dict = field(default_factory=dict)


def run_config(cfg, **overrides) -> DriverResult:
    """Run a ``ProblemConfig`` (e.g. one of ``config.BASELINE_CONFIGS``).

    ``overrides`` replace config fields (dataclasses.replace semantics), so
    tests/benchmarks can downsize: ``run_config(cfg, nx=16)``.
    """
    import dataclasses

    from ..mesh.io import load_unstructured_square
    from ..spaces.ensemble import coordinate_bisection_labels

    # driver-level (non-config) kwargs forwarded to the run_* functions
    fwd = {
        k: overrides.pop(k) for k in ("measure_warm",) if k in overrides
    }
    if overrides:
        gm = {k: overrides.pop(k) for k in ("m", "maxit", "tol") if k in overrides}
        if gm:
            overrides["gmres"] = dataclasses.replace(cfg.gmres, **gm)
        cfg = dataclasses.replace(cfg, **overrides)

    g = cfg.gmres
    if cfg.kind == "poisson":
        return run_poisson(nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol)
    if cfg.kind == "helmholtz":
        mesh = load_unstructured_square() if cfg.mesh == "unstructured_square" else None
        return run_helmholtz(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
            dtype=jnp.float32, mesh=mesh,
        )
    if cfg.kind == "helmholtz_ddh":
        mesh = load_unstructured_square() if cfg.mesh == "unstructured_square" else None
        return run_helmholtz_ddh(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
            wh_maxit=cfg.wh_maxit, transfer=cfg.transfer,
            mesh=mesh, n_domains=cfg.n_domains, **fwd,
        )
    if cfg.kind == "ddh":
        if cfg.mesh == "unstructured_square":
            mesh = load_unstructured_square()
            labels, ndom = coordinate_bisection_labels(mesh, cfg.n_domains or 8)
            return run_ddh(
                nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
                mesh=mesh, element_labels=labels, wh_maxit=cfg.wh_maxit,
                transfer=cfg.transfer, **fwd,
            )
        return run_ddh(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
            wh_maxit=cfg.wh_maxit, transfer=cfg.transfer,
            block_size=cfg.block_size, coarse=cfg.coarse, **fwd,
        )
    if cfg.kind == "ddh_multi":
        return run_ddh_multi_source(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
            n_sources=cfg.n_sources, transfer=cfg.transfer, **fwd,
        )
    raise ValueError(f"unknown config kind: {cfg.kind}")


def run_poisson(
    nx: int = 15,
    deg: int = 3,
    m: int = 20,
    maxit: int = 20,
    tol: float = 1e-6,
    dtype=jnp.float64,
    out_dir: str | None = None,
) -> DriverResult:
    """The Poisson example (Poisson.cpp:84-177)."""
    _require_x64(dtype)
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    def f(xy):
        return jnp.ones(xy.shape[:-1])

    def g(xy):
        x, y = xy[..., 0], xy[..., 1]
        right = jnp.abs(x - 1.0) < 1e-12
        left = jnp.abs(x + 1.0) < 1e-12
        return jnp.where(right, 1.0 - y * y, jnp.where(left, y * (1.0 - y * y), 0.0))

    t0 = time.perf_counter()
    u, out = solve_poisson(fem, fs, f, g, m=m, maxit=maxit, tol=tol, dtype=dtype)
    u.block_until_ready()
    dt = time.perf_counter() - t0
    u = np.asarray(u)
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/poisson.0000", u)
    return DriverResult(
        solution=u,
        coords=fem.coords,
        res_norm=np.asarray(out.res_norm)[: int(out.n_hist)],
        num_iter=int(out.num_iter),
        num_matvec=int(out.num_matvec),
        seconds=dt,
        success=bool(out.success),
    )


def run_helmholtz(
    nx: int = 128,
    deg: int = 3,
    m: int = 200,
    maxit: int = 10_000,
    tol: float = 1e-6,
    dtype=jnp.float64,
    mesh: Mesh2D | None = None,
    out_dir: str | None = None,
    max_seconds: float | None = None,
    verbose: int = 0,
) -> DriverResult:
    """The unpreconditioned coupled-Helmholtz example (Helmholtz.cpp:99-188).

    ``max_seconds`` bounds the solve wall-clock like the reference driver
    (2 h budget, Helmholtz.cpp:108 -> gmres.cpp:200-203); setting it (or
    ``verbose``) switches to the host-loop solver, which checks the clock
    between restarts and records per-restart times.
    """
    _require_x64(dtype)
    omega = 2 * np.pi * nx / 10
    grid = None
    if mesh is None:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        from ..ops.structured import GridH1Space

        fem = GridH1Space(mesh, Basis(deg + 1), nx, nx)
        grid = (nx, nx)
    else:
        fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    with _setup_scope():
        a2, af = project_coefficients(fem, fs, wave_speed_coeff, dtype=dtype)
        b = np.asarray(helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=dtype))
    op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=dtype)
    b = jnp.asarray(b)

    matvec = lambda U: apply_helmholtz(op, U, grid=grid)
    times = None
    t0 = time.perf_counter()
    if max_seconds is not None or verbose:
        from ..solvers.gmres import gmres_host

        out, times = gmres_host(
            matvec, b, m=m, maxit=maxit, tol=tol,
            max_seconds=max_seconds if max_seconds is not None else 6 * 3600,
            verbose=verbose,
        )
    else:
        solve = jax.jit(lambda b: gmres(matvec, b, m=m, maxit=maxit, tol=tol))
        out = solve(b)
    out.x.block_until_ready()
    dt = time.perf_counter() - t0
    U = np.asarray(out.x)
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/helmholtz.0000", U)
        write_history(
            f"{out_dir}/h_{nx}_{deg}.txt",
            np.asarray(out.res_norm)[: int(out.n_hist)],
            times,
        )
    return DriverResult(
        solution=U,
        coords=fem.coords,
        res_norm=np.asarray(out.res_norm)[: int(out.n_hist)],
        num_iter=int(out.num_iter),
        num_matvec=int(out.num_matvec),
        seconds=dt,
        success=bool(out.success),
        extra={"omega": omega, "ndof": fem.ndof},
    )


def run_ddh(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-4,
    mesh: Mesh2D | None = None,
    element_labels: np.ndarray | None = None,
    out_dir: str | None = None,
    wh_maxit: int = 5,
    transfer: bool = False,
    block_size: int = 16,
    measure_warm: bool = False,
    coarse: str | None = None,
    coarse_n_dir: int = 4,
    coarse_domains_per_super: int = 16,
    coarse_method: str = "direct",
    coarse_solve: tuple = (20, 2, 3e-2),
) -> DriverResult:
    """The DDH substructured-solver example (DDH.cpp:85-161).

    With the default structured mesh this matches the reference config
    (16x16-DOF subdomains); pass ``mesh`` + ``element_labels`` for
    unstructured domain decompositions (which the reference cannot do).
    ``transfer=True`` precomputes the per-subdomain trace-transfer matrices
    (pays ~2*pf wave cycles up front; each GMRES matvec is then one small
    batched matmul -- the right trade above ~2*pf matvecs).
    ``coarse="additive"|"multiplicative"`` (requires ``transfer``) enables
    the two-level plane-wave coarse correction (``solvers/coarse.py``,
    beyond the reference's strictly-one-level DDH).
    """
    omega = 2 * np.pi * nx / 10
    if mesh is None:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))

    # nodal interpolation of the coefficient (DDH.cpp:118-123)
    with _setup_scope():
        b_a = linear_functional(fem, wave_speed_coeff)
        mi = make_diag_inv_mass_op(fem)
        a_nodal = np.asarray(apply_diag_inv_mass(mi, b_a))
        b = np.asarray(helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)))
    b = jnp.asarray(b)

    t_setup = time.perf_counter()
    if element_labels is None:
        ddh = DDH(
            omega, a_nodal, fem, nx=nx, ny=nx, wh_maxit=wh_maxit,
            block_size=block_size,
        )
    else:
        ddh = DDH(
            omega, a_nodal, fem, element_labels=element_labels, wh_maxit=wh_maxit
        )
    pstats = {}
    if transfer:
        # load-or-compute the transfer/io maps (disk-cached by config hash:
        # repeat runs skip every probe cycle and their compiles)
        pstats = ddh.prepare(want_io=_want_io_maps())
    if coarse:
        if not transfer:
            raise ValueError("coarse correction requires transfer=True")
        sm, smx, stl = coarse_solve
        ddh.make_coarse(
            n_dir=coarse_n_dir, domains_per_super=coarse_domains_per_super,
            method=coarse_method, solve_m=sm, solve_maxit=smx, solve_tol=stl,
        )
    setup_s = time.perf_counter() - t_setup

    # state passed as jit arguments (see DDH.solver)
    solve = ddh.solver(m, maxit, tol, coarse=coarse)

    t0 = time.perf_counter()
    out, U = solve(b)
    U.block_until_ready()
    dt = time.perf_counter() - t0
    warm = {}
    if measure_warm:
        # compile-free number a user pays on every solve after the first
        t0 = time.perf_counter()
        jax.block_until_ready(solve(b))
        warm["warm_seconds"] = time.perf_counter() - t0
        warm["compile_seconds"] = dt - warm["warm_seconds"]
    U = np.asarray(U)
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/ddh.0000", U)
        write_history(
            f"{out_dir}/ddh_{nx}_{deg}.txt",
            np.asarray(out.res_norm)[: int(out.n_hist)],
        )
    return DriverResult(
        solution=U,
        coords=fem.coords,
        res_norm=np.asarray(out.res_norm)[: int(out.n_hist)],
        num_iter=int(out.num_iter),
        num_matvec=int(out.num_matvec),
        seconds=dt,
        success=bool(out.success),
        extra={
            "omega": omega,
            "ndof": fem.ndof,
            "n_lambda": ddh.size,
            "n_domains": ddh.n_domains,
            "nt": ddh.nt,
            "setup_seconds": setup_s,
            "precompute": pstats,
            "ddh": ddh,
            **warm,
        },
    )


def run_ddh_multi_source(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-4,
    n_sources: int = 8,
    source_radius: float = 0.5,
    transfer: bool = True,
    shard_sources: bool = False,
    out_dir: str | None = None,
    measure_warm: bool = False,
    method: str = "block",
    gmres_opts: dict | None = None,
) -> DriverResult:
    """Solve the DDH example for ``n_sources`` right-hand sides in ONE
    batched substructured solve (``jax.vmap`` over the full
    rhs -> lambda-GMRES -> postprocess pipeline).

    This capability has no reference analog (the CUDA driver solves one
    forcing per invocation, DDH.cpp:85-161): batching turns every
    (ndom, 2pf) @ (2pf, 2pf) transfer matvec into a (K*ndom, 2pf) one, so
    the transfer matrices are read once for K sources.  Sources are Gaussians spaced on a ring of
    ``source_radius``.

    ``method`` selects the batched solver:

    * ``"block"`` (default): ONE shared block-Krylov space for all K
      sources (``solvers.gmres.block_gmres``) — each restart spans m·K
      directions, so the restart count collapses versus per-source
      GMRES(m) (one operator, K forcings ⇒ heavily shared spectra) while
      each block step still costs a single batched matvec.  Per-source
      convergence is verified on true residuals.
    * ``"vmap"``: lock-step ``jax.vmap`` of the single-source solve; each
      source keeps its own Krylov space and per-source trajectories are
      bit-identical to solo solves (tests/test_drivers.py), but every lane
      runs to the SLOWEST lane's restart count.

    ``shard_sources=True`` additionally shards the source axis over all
    available devices (1-axis ``jax.sharding.Mesh``): sources are
    embarrassingly parallel, so XLA partitions the entire vmapped solve
    with no collectives beyond the shared loop-exit reduction -- the "data
    parallel" axis of this workload (tests/test_multichip.py validates
    lane-exact agreement with the replicated solve).
    """
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))

    with _setup_scope():
        b_a = linear_functional(fem, wave_speed_coeff)
        mi = make_diag_inv_mass_op(fem)
        a_nodal = np.asarray(apply_diag_inv_mass(mi, b_a))
        s = omega * omega
        th = 2 * np.pi * np.arange(n_sources) / n_sources
        centers = source_radius * np.stack([np.cos(th), np.sin(th)], axis=1)

        def source_k(cx, cy):
            def f(xy):
                r = (xy[..., 0] - cx) ** 2 + (xy[..., 1] - cy) ** 2
                return s / np.pi * jnp.exp(-s * r)

            return np.asarray(helmholtz_rhs(fem, f))

        bs = np.stack([source_k(cx, cy) for cx, cy in centers])
    if shard_sources:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec

        ndev = len(jax.devices())
        # largest divisor of n_sources that fits the device count
        n_shard = max(d for d in range(1, min(n_sources, ndev) + 1) if n_sources % d == 0)
        devs = np.array(jax.devices()[:n_shard])
        bs = jax.device_put(
            jnp.asarray(bs), NamedSharding(Mesh(devs, ("src",)), PartitionSpec("src"))
        )
    else:
        bs = jnp.asarray(bs)

    t_setup = time.perf_counter()
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx)
    pstats = {}
    if transfer:
        # load-or-compute the transfer/io maps (disk-cached by config hash:
        # repeat runs skip every probe cycle and their compiles)
        pstats = ddh.prepare(want_io=_want_io_maps())
    setup_s = time.perf_counter() - t_setup

    if method not in ("block", "vmap"):
        raise ValueError("method must be 'block' or 'vmap'")
    if gmres_opts is None and method == "block":
        # production block defaults: single-pass CGS — the block CholQR
        # keeps each new block internally orthonormal, so the CGS2
        # correction is redundant for the well-conditioned preconditioned
        # lambda systems — and statically-unrolled steps whose ortho
        # matmuls read only the populated basis rows (half the memory
        # traffic of the batched step's orthogonalisation)
        gmres_opts = {"reorth": False, "unroll": True}
    solve = ddh.solver(m, maxit, tol, gmres_opts=gmres_opts, **(
        {"block": True} if method == "block" else {"vmapped": True}
    ))

    t0 = time.perf_counter()
    outs, Us = solve(bs)
    Us.block_until_ready()
    dt = time.perf_counter() - t0
    warm = {}
    if measure_warm:
        t0 = time.perf_counter()
        jax.block_until_ready(solve(bs))
        warm["warm_seconds"] = time.perf_counter() - t0
        warm["compile_seconds"] = dt - warm["warm_seconds"]
    Us = np.asarray(Us)
    if method == "block":
        # shared space: one restart count / matvec total; per-source history
        # columns of the (maxit+1, K) record
        nh = int(np.asarray(outs.n_hist))
        hists = [np.asarray(outs.res_norm[:nh, k]) for k in range(n_sources)]
        per_restarts = [int(np.asarray(outs.num_iter))] * n_sources
        per_matvecs = [int(np.asarray(outs.num_matvec)) // n_sources] * n_sources
    else:
        n_hist = np.asarray(outs.n_hist)
        hists = [
            np.asarray(outs.res_norm[k])[: int(n_hist[k])]
            for k in range(n_sources)
        ]
        per_restarts = np.asarray(outs.num_iter).tolist()
        per_matvecs = np.asarray(outs.num_matvec).tolist()
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        for k in range(n_sources):
            to_file(f"{out_dir}/ddh_src{k:02d}.0000", Us[k])
            write_history(f"{out_dir}/ddh_src{k:02d}_{nx}_{deg}.txt", hists[k])
    # top-level scalar fields all describe SOURCE 0 (consistent with
    # res_norm); aggregates over the batch live in extra (success is the
    # one exception: the solve succeeded only if every source did)
    return DriverResult(
        solution=Us,
        coords=fem.coords,
        res_norm=hists[0],
        num_iter=per_restarts[0],
        num_matvec=per_matvecs[0],
        seconds=dt,
        success=bool(np.all(np.asarray(outs.success))),
        extra={
            "omega": omega,
            "ndof": fem.ndof,
            "n_sources": n_sources,
            "method": method,
            "per_source_matvecs": per_matvecs,
            "per_source_restarts": per_restarts,
            "max_matvecs": int(np.max(per_matvecs)),
            "histories": hists,
            "setup_seconds": setup_s,
            "precompute": pstats,
            "ddh": ddh,
            **warm,
        },
    )


# inner lambda-solve options: single-pass CGS + statically-unrolled steps
# cut its chain of small serialized kernels at identical convergence (the
# refinement loop's fp64 true-residual recompute catches any inner
# sloppiness by construction)
_FAST_INNER = {"reorth": False, "unroll": True}


def _make_matvec32(omega, a2, af, fem, fs, mesh, nx=None):
    """fp32 coupled-Helmholtz matvec for the refinement inner solves.

    On structured meshes the operator is rebuilt on a ``GridH1Space`` so
    the 1D-factorised kron fast path applies, with cheap gather
    permutations translating between the reference H1 numbering (which the
    DDH and rhs use) and the grid numbering.  Falls back to the generic
    element-batched operator on unstructured meshes.
    """
    a2_32 = np.asarray(a2, np.float32)
    af_32 = np.asarray(af, np.float32)
    if nx is None:
        op32 = make_helmholtz_op(omega, a2_32, af_32, fem, fs, dtype=jnp.float32)
        return lambda U: apply_helmholtz(op32, U)

    from ..ops.structured import GridH1Space

    gfem = GridH1Space(mesh, fem.basis, nx, nx)
    # numbering permutations via the shared (el, i, j) node tables
    g2h = np.zeros(gfem.ndof, np.int64)  # grid dof -> h1 dof (same node)
    g2h[gfem.dofs.reshape(-1)] = fem.dofs.reshape(-1)
    h2g = np.zeros(fem.ndof, np.int64)
    h2g[fem.dofs.reshape(-1)] = gfem.dofs.reshape(-1)
    fs_g = FaceSpace(gfem, mesh.boundary_edges)
    # face coefficient remap: match face DOFs by shared global node
    inv_fs = np.zeros(fem.ndof, np.int64)
    inv_fs[np.asarray(fs.proj)] = np.arange(len(np.asarray(fs.proj)))
    af_g = af_32[inv_fs[g2h[np.asarray(fs_g.proj)]]]
    op32 = make_helmholtz_op(
        omega, a2_32[g2h], af_g, gfem, fs_g, dtype=jnp.float32
    )
    g2h_j, h2g_j = jnp.asarray(g2h), jnp.asarray(h2g)
    n = fem.ndof

    def matvec32(U):
        Ug = jnp.concatenate([U[:n][g2h_j], U[n:][g2h_j]])
        Yg = apply_helmholtz(op32, Ug)  # kron at true fp32 (ops/kron.py)
        return jnp.concatenate([Yg[:n][h2g_j], Yg[n:][h2g_j]])

    return matvec32


def run_helmholtz_ddh(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    inner_m: int = 20,
    inner_maxit: int = 3,
    inner_gmres_opts: dict | None = _FAST_INNER,
    wh_maxit: int = 5,
    transfer: bool = True,
    dtype=jnp.float64,
    mesh: Mesh2D | None = None,
    element_labels: np.ndarray | None = None,
    n_domains: int | None = None,
    out_dir: str | None = None,
    refine: bool = True,
    max_refine: int = 6,
    measure_warm: bool = True,
    omega: float | None = None,
) -> DriverResult:
    """Solve the coupled Helmholtz system to ``tol`` with FGMRES
    right-preconditioned by the DDH substructured solver.

    Beyond the reference: its DDH example stops at the lambda-system solve
    (rel 1e-4 on the traces, DDH.cpp:141-155) and its Helmholtz example runs
    unpreconditioned GMRES(200), which stagnates for hours before 1e-6.
    Here each outer FGMRES step applies one bounded inner DDH solve
    (``inner_maxit`` lambda restarts, no early exit) as the preconditioner,
    driving the TRUE coupled residual to 1e-6 in a handful of outer steps.

    Precision (``refine=True``, the default for fp64 targets):
    mixed-precision iterative refinement moves all Krylov work to fp32:
    each step solves the residual equation ``A dx = r`` with fp32
    FGMRES-DDH to a loose relative tolerance, corrects ``x`` in fp64, and
    recomputes the TRUE residual with the fp64 operator -- one fp64 matvec
    per refinement step (2-3 total) instead of one per Arnoldi step.  An
    fp32 solve alone floors at ~2e-6 relative residual; the fp64 residual
    recomputation removes that floor, so the scheme reaches any tolerance
    down to fp64 grade.  Whether it beats a plain fp64 outer solve on a
    GPU with native fp64 is not measured yet.  ``refine=False`` restores
    the all-``dtype`` outer FGMRES.

    ``measure_warm=True`` runs the converged solve a second time to split
    jit-compile from execution (the reference's solver_out separates
    per-restart times from the solve, gmres.cpp:122-126,197-201):
    ``extra["warm_seconds"]`` is the compile-free number, ``seconds`` keeps
    the first (compile-inclusive) wall time.

    Pass ``mesh`` (+ optional ``element_labels``; default recursive
    coordinate bisection into ``n_domains`` parts) to run on an arbitrary
    quad mesh, e.g. the unstructured square — the BASELINE target metric
    (GMRES iters-to-1e-6 on the unstructured square).  The reference's DDH
    cannot do this (uniform_rect only, DDH.cpp:333-344).
    """
    from ..solvers.gmres import fgmres

    _require_x64(dtype)
    if omega is None:
        omega = 2 * np.pi * nx / 10  # the reference drivers' scaling
    structured = mesh is None
    if structured:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        # GRID-NATIVE numbering for the whole structured pipeline: building
        # the DDH, the coefficients, and both coupled operators on the
        # row-major GridH1Space removes two ~148k-element permutation
        # gathers from EVERY outer Arnoldi step.
        # The solution is renumbered to the reference H1 ordering once, at
        # the end, for artifact/test parity.
        from ..ops.structured import GridH1Space

        fem = GridH1Space(mesh, Basis(deg + 1), nx, nx)
    else:
        if element_labels is None:
            from ..spaces.ensemble import coordinate_bisection_labels

            element_labels, n_domains = coordinate_bisection_labels(
                mesh, n_domains or max(4, mesh.n_elem // 16)
            )
        fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    with _setup_scope():
        a2, af = project_coefficients(fem, fs, wave_speed_coeff, dtype=dtype)
        b_a = linear_functional(fem, wave_speed_coeff)
        mi = make_diag_inv_mass_op(fem)
        a_nodal = np.asarray(apply_diag_inv_mass(mi, b_a))
        b = np.asarray(helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=dtype))
    op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=dtype)
    b = jnp.asarray(b)

    t_setup = time.perf_counter()
    if structured:
        ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, wh_maxit=wh_maxit)
    else:
        ddh = DDH(
            omega, a_nodal, fem, element_labels=element_labels,
            n_domains=n_domains, wh_maxit=wh_maxit,
        )
    pstats = {}
    if transfer:
        # load-or-compute the transfer/io maps (disk-cached by config hash:
        # repeat runs skip every probe cycle and their compiles)
        pstats = ddh.prepare(want_io=_want_io_maps())
    setup_s = time.perf_counter() - t_setup

    igo = inner_gmres_opts or {}

    def P(v):
        # bounded fp32 inner solve, no early exit: deterministic work/apply.
        # The io maps run at their default true fp32 (docs/DTYPES.md).
        v32 = v.astype(jnp.float32)
        Y = ddh.rhs(v32)
        out = gmres(ddh.action, Y, m=inner_m, maxit=inner_maxit, tol=0.0, **igo)
        return ddh.postprocess(out.x, v32).astype(v.dtype)

    use_refine = refine and jnp.dtype(dtype) == jnp.dtype("float64")
    extra = {"omega": omega, "ndof": fem.ndof, "setup_seconds": setup_s,
             "precompute": pstats, "refine": use_refine}

    if use_refine:
        if structured:
            # fem IS grid-numbered: the kron fast path applies directly,
            # no permutation gathers (see _make_matvec32 for the mixed-
            # numbering variant used when the DDH must keep H1 ordering)
            op32 = make_helmholtz_op(
                omega, np.asarray(a2, np.float32), np.asarray(af, np.float32),
                fem, fs, dtype=jnp.float32,
            )
            matvec32 = lambda U: apply_helmholtz(op32, U)
        else:
            matvec32 = _make_matvec32(omega, a2, af, fem, fs, mesh, None)
        matvec64 = jax.jit(lambda U: apply_helmholtz(op, U))

        # DDH state passed as jit ARGUMENTS (the same pattern as
        # DDH.solver): closing over the io maps would embed them as HLO
        # constants (~300 MB at nu=256, pad=384)
        T_cap = None
        if ddh.use_transfer and ddh.route is None and ddh._T_u is not None:
            T_cap = ddh.T
        dstate = (ddh.params, T_cap, ddh.route, ddh.io)

        def _inner_fn(r, tl, st):
            old = (ddh.params, ddh._T_dev, ddh.route, ddh.io)
            ddh.params, ddh._T_dev, ddh.route, ddh.io = st
            try:
                # deferred=True: per-restart normal-equations least squares
                # instead of per-step Givens chains of serialized small
                # kernels; exit checks move to restart boundaries, which the
                # refinement loop's loose inner tolerances make nearly free
                return fgmres(matvec32, r, P, m=m, maxit=maxit, tol=tl,
                              deferred=True)
            finally:
                ddh.params, ddh._T_dev, ddh.route, ddh.io = old

        _inner_jit = jax.jit(_inner_fn)
        inner = lambda r, tl: _inner_jit(r, tl, dstate)

        def solve_once(bv):
            x = jnp.zeros(2 * fem.ndof, dtype=jnp.float64)
            bnrm = float(jnp.linalg.norm(bv))
            r, rn = bv, bnrm
            outer_hist, inner_hists, tols = [rn], [], []
            iters = mvs = steps = 0
            stagnated = False
            while rn > tol * bnrm and steps < max_refine:
                # contract toward the target with 0.3 safety, but never
                # deeper than 2e-5 per inner solve: fp32 FGMRES convergence
                # degrades near its ~2e-6 representation floor
                tl = min(0.5, max(2e-5, 0.3 * tol * bnrm / rn))
                out = inner(r.astype(jnp.float32), jnp.float32(tl))
                x = x + out.x.astype(jnp.float64)
                r = bv - matvec64(x)
                rn_new = float(jnp.linalg.norm(r))
                outer_hist.append(rn_new)
                inner_hists.append(np.asarray(out.res_norm)[: int(out.n_hist)])
                tols.append(tl)
                iters += int(out.num_iter)
                mvs += int(out.num_matvec) + 1
                steps += 1
                if rn_new >= 0.9 * rn:  # stagnation guard
                    rn = rn_new
                    stagnated = rn > tol * bnrm
                    break
                rn = rn_new
            return (
                x, outer_hist, inner_hists, tols, iters, mvs, steps,
                rn <= tol * bnrm, stagnated,
            )

        t0 = time.perf_counter()
        x, outer_hist, inner_hists, tols, iters, mvs, steps, ok, stag = solve_once(b)
        np.asarray(x)
        dt = time.perf_counter() - t0
        if measure_warm:
            t0 = time.perf_counter()
            x, outer_hist, inner_hists, tols, iters, mvs, steps, ok, stag = solve_once(b)
            np.asarray(x)
            extra["warm_seconds"] = time.perf_counter() - t0
            extra["compile_seconds"] = dt - extra["warm_seconds"]
        U = np.asarray(x)
        res_hist = np.asarray(outer_hist)
        # convergence contract: success=False alone cannot distinguish "hit
        # max_refine" from "refinement stopped making progress", so the
        # stagnation cause is surfaced explicitly
        extra.update(
            refine_steps=steps,
            stagnated=stag,
            inner_tols=tols,
            inner_histories=[h.tolist() for h in inner_hists],
        )
        num_iter, num_matvec, success = iters, mvs, ok
    else:
        matvec = lambda U: apply_helmholtz(op, U)
        solve = jax.jit(lambda b: fgmres(matvec, b, P, m=m, maxit=maxit, tol=tol))
        t0 = time.perf_counter()
        out = solve(b)
        out.x.block_until_ready()
        dt = time.perf_counter() - t0
        if measure_warm:
            t0 = time.perf_counter()
            jax.block_until_ready(solve(b))
            extra["warm_seconds"] = time.perf_counter() - t0
            extra["compile_seconds"] = dt - extra["warm_seconds"]
        U = np.asarray(out.x)
        res_hist = np.asarray(out.res_norm)[: int(out.n_hist)]
        num_iter, num_matvec, success = int(out.num_iter), int(out.num_matvec), bool(out.success)

    coords_out = fem.coords
    if structured:
        # renumber grid -> reference H1 ordering once (artifact/test parity
        # with the reference drivers; the solve itself ran grid-native)
        fem_ref = H1Space(mesh, Basis(deg + 1))
        r2g = np.zeros(fem.ndof, np.int64)
        r2g[np.asarray(fem_ref.dofs).reshape(-1)] = np.asarray(
            fem.dofs
        ).reshape(-1)
        nd = fem.ndof
        U = np.concatenate([U[:nd][r2g], U[nd:][r2g]])
        coords_out = fem_ref.coords
    if out_dir:
        to_file(f"{out_dir}/xy.0000", np.asarray(coords_out).T)
        to_file(f"{out_dir}/helmholtz_ddh.0000", U)
        write_history(f"{out_dir}/hddh_{nx}_{deg}.txt", res_hist)
    return DriverResult(
        solution=U,
        coords=coords_out,
        res_norm=res_hist,
        num_iter=num_iter,
        num_matvec=num_matvec,
        seconds=dt,
        success=success,
        extra=extra,
    )


def main(argv=None):
    """CLI: run a named BASELINE config.

    python -m cuddhelmholtz_tpu.examples.drivers <name> [field=value ...]
    """
    import json
    import sys

    from ..config import BASELINE_CONFIGS

    argv = sys.argv[1:] if argv is None else argv
    by_name = {c.name: c for c in BASELINE_CONFIGS}
    if not argv or argv[0] not in by_name:
        print(f"usage: drivers <{'|'.join(by_name)}> [nx=..] [m=..] [maxit=..] [tol=..]")
        return 1
    cfg = by_name[argv[0]]
    overrides = {}
    for kv in argv[1:]:
        k, v = kv.split("=", 1)
        overrides[k] = float(v) if k == "tol" else int(v)
    res = run_config(cfg, **overrides)
    rec = {
        "config": cfg.name,
        "success": bool(res.success),
        "iters": int(res.num_iter),
        "matvecs": int(res.num_matvec),
        "seconds": res.seconds,
        "final_rel_res": float(res.res_norm[-1] / res.res_norm[0]),
    }
    # warm/compile split and refinement structure, when the driver records
    # them (run_helmholtz_ddh): the warm number is the solve cost a user
    # pays on every solve after the first
    for k in ("warm_seconds", "compile_seconds", "refine_steps", "stagnated", "setup_seconds"):
        if k in res.extra:
            rec[k] = res.extra[k]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
