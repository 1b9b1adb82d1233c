"""Multi-chip sharding tests on the simulated 8-device CPU mesh.

The reference has no distributed code at all; these tests validate the
sharded layer: element-sharded operator apply and
subdomain-sharded DDH must reproduce the single-device results exactly
(deterministic segment-sum assembly + psum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu.ops.mass import apply_mass, make_mass_op
from cuddhelmholtz_tpu.ops.stiffness import apply_stiffness, make_stiffness_op
from cuddhelmholtz_tpu.parallel.sharding import (
    ShardedDDH,
    device_mesh,
    shard_mass_op,
    shard_stiffness_op,
    sharded_helmholtz_matvec,
    sharded_mass_apply,
    sharded_stiffness_apply,
)
from cuddhelmholtz_tpu.solvers.ddh import DDH
from cuddhelmholtz_tpu.solvers.gmres import gmres
from cuddhelmholtz_tpu.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu.utils.basis import Basis


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return device_mesh(8)


def test_sharded_stiffness_matches(mesh8):
    mesh = Mesh2D.uniform_rect(10, -1, 1, 10, -1, 1)
    fem = H1Space(mesh, Basis(5))
    op = make_stiffness_op(fem)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(fem.ndof))

    want = apply_stiffness(op, x)
    sop = shard_stiffness_op(op, mesh8)
    apply_fn = sharded_stiffness_apply(op, mesh8)
    got = apply_fn(sop, x)
    assert np.allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_sharded_mass_matches(mesh8):
    mesh = Mesh2D.uniform_rect(10, -1, 1, 10, -1, 1)
    fem = H1Space(mesh, Basis(4))
    rng = np.random.default_rng(7)
    a = 1.0 + 0.5 * rng.random(fem.ndof)
    op = make_mass_op(fem, coeff=a)
    x = jnp.asarray(rng.standard_normal(fem.ndof))

    want = apply_mass(op, x)
    sop = shard_mass_op(op, mesh8)
    apply_fn = sharded_mass_apply(op, mesh8)
    got = apply_fn(sop, x)
    assert np.allclose(np.asarray(got), np.asarray(want), atol=1e-12)


def test_sharded_helmholtz_matvec_matches(mesh8):
    """Element-sharded coupled Helmholtz action == the single-device action,
    and a short sharded GMRES reproduces the single-device trajectory."""
    from cuddhelmholtz_tpu.models.helmholtz import (
        apply_helmholtz,
        make_helmholtz_op,
        project_coefficients,
    )

    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    def coeff(xy):
        r = xy[..., 0] ** 2 + xy[..., 1] ** 2
        return jnp.where(r < 0.0625, 0.2, 1.0)

    a2, af = project_coefficients(fem, fs, coeff)
    op = make_helmholtz_op(omega, a2, af, fem, fs)

    rng = np.random.default_rng(11)
    U = jnp.asarray(rng.standard_normal(2 * fem.ndof))
    want = apply_helmholtz(op, U)
    matvec = sharded_helmholtz_matvec(op, mesh8)
    got = matvec(U)
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(np.asarray(got) - np.asarray(want)).max() < 1e-11 * scale

    b = jnp.zeros(2 * fem.ndof).at[: fem.ndof].set(
        jnp.asarray(rng.standard_normal(fem.ndof))
    )
    out = gmres(matvec, b, m=10, maxit=3, tol=1e-10)
    ref = gmres(lambda u: apply_helmholtz(op, u), b, m=10, maxit=3, tol=1e-10)
    h1 = np.asarray(out.res_norm)[: int(out.n_hist)]
    h2 = np.asarray(ref.res_norm)[: int(ref.n_hist)]
    assert np.allclose(h1, h2, rtol=1e-9)


def test_sharded_ddh_matches(mesh8):
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    a_nodal = np.ones(fem.ndof)
    # 16 subdomains of 2x2 elements (block_size 8) so 8 devices divide evenly
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8, wh_maxit=1)
    sddh = ShardedDDH(ddh, mesh8)

    rng = np.random.default_rng(1)
    lam = jnp.asarray(rng.standard_normal(ddh.size), jnp.float32)
    f = jnp.asarray(rng.standard_normal(2 * fem.ndof), jnp.float32)

    a1 = np.asarray(ddh.action(lam))
    a2 = np.asarray(sddh.action(lam))
    assert np.allclose(a1, a2, atol=1e-5), np.abs(a1 - a2).max()

    r1 = np.asarray(ddh.rhs(f))
    r2 = np.asarray(sddh.rhs(f))
    assert np.allclose(r1, r2, atol=1e-5)

    p1 = np.asarray(ddh.postprocess(lam, f))
    p2 = np.asarray(sddh.postprocess(lam, f))
    assert np.allclose(p1, p2, atol=1e-5)


def test_sharded_ddh_transfer_action_matches(mesh8):
    """Sharded transfer-matrix action == single-device wave-cycle action."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    a_nodal = np.ones(fem.ndof)
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8, wh_maxit=1)
    rng = np.random.default_rng(3)
    lam = jnp.asarray(rng.standard_normal(ddh.size), jnp.float32)
    ddh.use_transfer = False
    want = np.asarray(ddh.action(lam))

    ddh.precompute_transfer()
    sddh = ShardedDDH(ddh, mesh8)
    assert sddh.use_transfer
    got = np.asarray(sddh.action(lam))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() < 1e-4 * scale


def test_sharded_ddh_ppermute_rolls_match(mesh8):
    """The ppermute halo-exchange (rolled) sharded action == the single-device
    rolled action.  Needs route offsets to fit within one chip's block:
    16x16 elements / block 8 -> 8x8 subdomains, offsets (+-1, +-8), 8 rows
    per chip."""
    nx, deg = 16, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    ddh = DDH(omega, np.ones(fem.ndof), fem, nx=nx, ny=nx, block_size=8, wh_maxit=1)
    rng = np.random.default_rng(5)
    lam = jnp.asarray(rng.standard_normal(ddh.size), jnp.float32)
    ddh.precompute_transfer()
    assert ddh.route is not None
    want = np.asarray(ddh.action(lam))

    sddh = ShardedDDH(ddh, mesh8)
    assert sddh._roll_data is not None, "halo-exchange path must engage"
    got = np.asarray(sddh.action(lam))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() < 1e-5 * scale


def test_sharded_ddh_gmres_step(mesh8):
    """A full substructured GMRES solve through the sharded action."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    a_nodal = np.ones(fem.ndof)
    # CFL-stable nt (no nt_override); wh_maxit=1 keeps CPU cost down
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8, wh_maxit=1)
    sddh = ShardedDDH(ddh, mesh8)
    rng = np.random.default_rng(2)
    f = jnp.asarray(rng.standard_normal(2 * fem.ndof), jnp.float32)
    Y = sddh.rhs(f)
    out = gmres(sddh.action, Y, m=5, maxit=5, tol=1e-6)
    ref = gmres(ddh.action, ddh.rhs(f), m=5, maxit=5, tol=1e-6)
    # fp32 reduction orders differ between layouts; trajectories must agree
    # to a few ulps' worth of accumulated difference
    h1 = np.asarray(out.res_norm)[: int(out.n_hist)]
    h2 = np.asarray(ref.res_norm)[: int(ref.n_hist)]
    k = min(len(h1), len(h2))
    assert np.allclose(h1[:k], h2[:k], rtol=1e-3)
    scale = np.linalg.norm(np.asarray(ref.x))
    assert np.linalg.norm(np.asarray(out.x) - np.asarray(ref.x)) < 1e-2 * scale


def test_source_axis_data_parallel():
    """Sharding the source axis of the batched multi-RHS solve over the mesh
    reproduces the replicated vmapped solve lane-exactly -- the 'data
    parallel' axis of this workload (sources are embarrassingly parallel)."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    nx, deg, K = 8, 3, 8
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    ddh = DDH(omega, np.ones(fem.ndof), fem, nx=nx, ny=nx)

    rng = np.random.default_rng(0)
    bs_np = rng.standard_normal((K, 2 * fem.ndof)).astype(np.float32) * 1e-2
    jmesh = JMesh(np.array(jax.devices()[:8]), ("src",))
    bs = jax.device_put(jnp.asarray(bs_np), NamedSharding(jmesh, P("src")))

    def solve_one(b):
        Y = ddh.rhs(b)
        out = gmres(ddh.action, Y, m=10, maxit=8, tol=1e-3)
        return ddh.postprocess(out.x, b), out.num_matvec

    solve = jax.jit(jax.vmap(solve_one))
    Us, nmv = solve(bs)
    assert "src" in str(Us.sharding.spec)  # result stays sharded
    U_ref, nmv_ref = solve(jnp.asarray(bs_np))
    assert np.array_equal(np.asarray(nmv), np.asarray(nmv_ref))
    d = np.linalg.norm(np.asarray(Us) - np.asarray(U_ref)) / np.linalg.norm(
        np.asarray(U_ref)
    )
    assert d < 1e-5, d
