"""Problem/solver configuration (replaces the reference's hardcoded main()s).

SURVEY.md section 5 notes all reference problem parameters are compile-time
constants in the drivers; BASELINE.json makes configs the benchmark matrix,
so they are first-class dataclasses here.  ``BASELINE_CONFIGS`` mirrors the
five BASELINE.json configurations.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class GmresConfig:
    m: int = 20
    maxit: int = 100
    tol: float = 1e-6


@dataclass(frozen=True)
class ProblemConfig:
    name: str
    kind: str  # "poisson" | "helmholtz" | "ddh" | "helmholtz_ddh"
    nx: int = 128
    deg: int = 3
    mesh: str = "uniform_rect"  # or "unstructured_square"
    gmres: GmresConfig = field(default_factory=GmresConfig)
    wh_maxit: int = 5
    rhs_split: str = "full"
    n_domains: int | None = None  # for unstructured partitions
    # precompute per-subdomain trace-transfer matrices (the production DDH
    # matvec; pays ~2*pf wave-cycle columns once, wins above ~2*pf matvecs)
    transfer: bool = True
    # kind="ddh_multi": number of right-hand sides solved in one batched
    # (vmapped) substructured solve
    n_sources: int = 8
    # DDH subdomain side length in DOFs (the reference hard-codes 16,
    # DDH.cpp:5; 32 cuts high-frequency iteration counts ~3.5x at nx=512)
    block_size: int = 16
    # two-level coarse correction: None | "additive" | "multiplicative"
    # (solvers/coarse.py; requires transfer=True)
    coarse: str | None = None

    @property
    def omega(self) -> float:
        import numpy as np

        return 2 * np.pi * self.nx / 10


BASELINE_CONFIGS = (
    ProblemConfig(
        name="poisson_structured",
        kind="poisson",
        nx=15,
        gmres=GmresConfig(m=20, maxit=20, tol=1e-6),
    ),
    ProblemConfig(
        name="helmholtz_unpreconditioned",
        kind="helmholtz",
        nx=128,
        gmres=GmresConfig(m=200, maxit=10_000, tol=1e-6),
    ),
    ProblemConfig(
        name="ddh_structured",
        kind="ddh",
        nx=128,
        gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
    ),
    ProblemConfig(
        name="ddh_unstructured_square",
        kind="ddh",
        nx=8,  # sets omega; geometry comes from the mesh file
        mesh="unstructured_square",
        n_domains=8,
        gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
    ),
    ProblemConfig(
        name="ddh_high_frequency",
        kind="ddh",
        nx=256,  # omega = 2*pi*25.6
        gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
    ),
    # beyond-reference scale: 2.4M DOF at 4x the reference frequency with
    # 32-DOF subdomain blocks (the one-level-DD frequency fix; the
    # reference hard-codes 16-DOF blocks and tops out at nx=128)
    ProblemConfig(
        name="ddh_512_block32",
        kind="ddh",
        nx=512,  # omega = 2*pi*51.2
        block_size=32,
        gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
    ),
    # beyond-reference: the coupled system to 1e-6 (fp64 FGMRES outer,
    # bounded fp32 DDH inner solve as right preconditioner)
    ProblemConfig(
        name="helmholtz_ddh_1e6",
        kind="helmholtz_ddh",
        nx=128,
        gmres=GmresConfig(m=20, maxit=100, tol=1e-6),
    ),
    # the BASELINE target metric: GMRES iters-to-1e-6 on the unstructured
    # square, DDH-preconditioned (coordinate-bisection partition)
    ProblemConfig(
        name="helmholtz_ddh_unstructured_1e6",
        kind="helmholtz_ddh",
        nx=8,  # sets omega; geometry comes from the mesh file
        mesh="unstructured_square",
        n_domains=8,
        gmres=GmresConfig(m=20, maxit=100, tol=1e-6),
    ),
    # beyond-reference: 8 right-hand sides in one vmapped substructured
    # solve (the reference runs one forcing per invocation)
    ProblemConfig(
        name="ddh_multi_source_8",
        kind="ddh_multi",
        nx=128,
        n_sources=8,
        # m=40 for the BLOCK multi-source solver: the shared m*K space cuts
        # restarts 17 -> 7 at K=8 and the longer cycle amortises the
        # per-restart true-residual matvec + small-op overhead
        gmres=GmresConfig(m=40, maxit=100, tol=1e-4),
    ),
)
