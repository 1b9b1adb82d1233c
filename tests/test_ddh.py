"""DDH preconditioner tests.

The reference validates DDH only through its example driver; here we test the
pieces directly:
  * the dense per-subdomain stiffness equals the GLL-collocated global
    stiffness when one subdomain covers the whole mesh;
  * the action is affine-consistent (action(lam) - action(0) is linear);
  * the substructured GMRES converges and the postprocessed solution
    approximates the directly-solved discrete Helmholtz solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu.models.helmholtz import (
    apply_helmholtz,
    helmholtz_rhs,
    make_helmholtz_op,
    project_coefficients,
)
from cuddhelmholtz_tpu.ops.functional import linear_functional
from cuddhelmholtz_tpu.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from cuddhelmholtz_tpu.ops.stiffness import apply_stiffness, make_stiffness_op
from cuddhelmholtz_tpu.solvers.ddh import DDH, _apply_S
from cuddhelmholtz_tpu.solvers.gmres import gmres
from cuddhelmholtz_tpu.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu.utils.basis import Basis


def test_subdomain_stiffness_matches_global():
    """Single-domain DDH stiffness == GLL-collocated global stiffness."""
    nx, nb = 4, 4
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(nb))
    a = np.ones(fem.ndof)
    ddh = DDH(
        2 * np.pi, a, fem, element_labels=np.zeros(mesh.n_elem, int), nt_override=4
    )
    p = ddh.params

    rng = np.random.default_rng(0)
    x = rng.standard_normal(fem.ndof)
    # map to the (1, pad) subdomain layout
    gI = np.asarray(p.gI)[0]
    xe = np.where(gI >= 0, x[np.maximum(gI, 0)], 0.0).astype(np.float32)
    z = _apply_S(p.S, jnp.asarray(xe[None, :]))[0]
    # back to global ordering
    got = np.zeros(fem.ndof, dtype=np.float64)
    got[gI[gI >= 0]] = np.asarray(z)[gI >= 0]

    stiff = make_stiffness_op(fem, quad=fem.basis.quadrature)
    want = np.asarray(apply_stiffness(stiff, jnp.asarray(x)))
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-5, err  # fp32 subdomain data vs fp64 reference


@pytest.fixture(scope="module")
def small_ddh():
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10  # the reference drivers' frequency scaling
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))

    def alpha(xy):
        r = xy[..., 0] ** 2 + xy[..., 1] ** 2
        return jnp.where(r < 0.0625, 0.2, 1.0)

    b_a = linear_functional(fem, alpha)
    mi = make_diag_inv_mass_op(fem)
    a_nodal = np.asarray(apply_diag_inv_mass(mi, b_a))

    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx)
    return mesh, fem, omega, a_nodal, alpha, ddh


def test_ddh_action_affine_consistency(small_ddh):
    mesh, fem, omega, a_nodal, alpha, ddh = small_ddh
    rng = np.random.default_rng(1)
    n = ddh.size
    # own-slot layout: every surviving trace id is its compact slot position,
    # overwritten (corner) ids ride in a tail, dead slots are zero-padding
    assert n == 2 * ddh.n_lambda
    assert ddh.n_lambda == ddh.n_own + ddh.n_lost
    # surviving ids (2*n_shared - n_lost) each occupy one distinct own slot
    assert 2 * ddh.efem.n_shared_dofs - ddh.n_lost <= ddh.n_own
    l1 = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    l2 = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    a0 = ddh.action(jnp.zeros(n, jnp.float32))
    a1 = ddh.action(l1)
    a2 = ddh.action(l2)
    a12 = ddh.action(l1 + 2.0 * l2)
    lin = (a1 - a0) + 2.0 * (a2 - a0) + a0
    err = np.linalg.norm(a12 - lin) / np.linalg.norm(np.asarray(a12))
    assert err < 1e-4, err
    # with zero volume forcing, action(0) == 0 (homogeneous system)
    assert np.linalg.norm(np.asarray(a0)) < 1e-6


def _lumped_global_solution(mesh, fem, omega, a_nodal, b):
    """Direct solve of the GLL-collocated (lumped) global discretization --
    the discretization the DDH subdomain problems are built from."""
    from cuddhelmholtz_tpu.ops.mass import lumped_mass_diagonal

    n = fem.ndof
    stiff = make_stiffness_op(fem, quad=fem.basis.quadrature)
    mlump = jnp.asarray(lumped_mass_diagonal(fem) * a_nodal**2)
    fs = FaceSpace(fem, mesh.boundary_edges)
    Hb = np.zeros(n)
    edge_meas = 0.5 * mesh.edge_lengths()
    qw = fem.basis.quadrature.w
    for i, e in enumerate(fs.faces):
        np.add.at(Hb, fs.proj[fs.face_dofs[i]], edge_meas[e] * qw)
    Hba = jnp.asarray(Hb * a_nodal)
    w2 = omega * omega

    def matvec(U):
        u, v = U[:n], U[n:]
        Au = apply_stiffness(stiff, u) - w2 * mlump * u - omega * Hba * v
        Av = -(apply_stiffness(stiff, v) - w2 * mlump * v + omega * Hba * u)
        return jnp.concatenate([Au, Av])

    out = gmres(matvec, b, m=120, maxit=150, tol=1e-6)
    assert bool(out.success)
    return np.asarray(out.x)


def test_ddh_solves_helmholtz(small_ddh):
    mesh, fem, omega, a_nodal, alpha, ddh = small_ddh

    def f(xy):
        s = omega * omega
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return s / np.pi * jnp.exp(-s * r)

    b = helmholtz_rhs(fem, f)

    # substructured solve (fp32, like the reference driver: GMRES(20), 1e-4)
    Y = ddh.rhs(b)
    out = gmres(ddh.action, Y, m=20, maxit=100, tol=1e-4)
    assert bool(out.success), np.asarray(out.res_norm)[: int(out.n_hist)]
    U = ddh.postprocess(out.x, b)

    xd = _lumped_global_solution(mesh, fem, omega, a_nodal, b)
    rel = np.linalg.norm(np.asarray(U) - xd) / np.linalg.norm(xd)
    # the reference formulation carries localized interface defects (full-F
    # double counting + cross-point exchange); measured ~0.10 on this config
    assert rel < 0.15, rel


def test_ddh_mass_split_is_more_consistent(small_ddh):
    """The mass-fraction rhs split (our improvement over the reference's
    full-F convention) roughly halves the interface defect."""
    mesh, fem, omega, a_nodal, alpha, _ = small_ddh
    nx = 8

    def f(xy):
        r = (xy[..., 0] + 0.3) ** 2 + (xy[..., 1] - 0.2) ** 2
        return jnp.exp(-r / (2 * 0.2**2))

    b = helmholtz_rhs(fem, f)
    xd = _lumped_global_solution(mesh, fem, omega, a_nodal, b)

    rels = {}
    for split in ("full", "mass"):
        ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, rhs_split=split)
        Y = ddh.rhs(b)
        out = gmres(ddh.action, Y, m=20, maxit=40, tol=1e-5)
        U = ddh.postprocess(out.x, b)
        rels[split] = np.linalg.norm(np.asarray(U) - xd) / np.linalg.norm(xd)
    assert rels["mass"] < rels["full"]
    assert rels["mass"] < 0.09, rels


def test_ddh_transfer_operator_matches_action(small_ddh):
    """The precomputed per-subdomain scattering matrices reproduce the
    wave-cycle action exactly (the cycle is linear in the traces), and the
    substructured GMRES converges to the same solution through them."""
    mesh, fem, omega, a_nodal, alpha, ddh = small_ddh
    rng = np.random.default_rng(3)
    lam = jnp.asarray(rng.standard_normal(ddh.size), jnp.float32)
    y_direct = np.asarray(ddh.action(lam))
    try:
        ddh.precompute_transfer()
        assert ddh.T.shape[0] == ddh.n_domains
        # structured partitions get the roll-based exchange; it must agree
        # with the scatter-exchange transfer apply and the wave-cycle action
        assert ddh.route is not None
        y_t = np.asarray(ddh.action(lam))
        err = np.linalg.norm(y_t - y_direct) / np.linalg.norm(y_direct)
        assert err < 2e-5, err

        from cuddhelmholtz_tpu.solvers.ddh import ddh_action_transfer

        y_s = np.asarray(ddh_action_transfer(ddh.params, ddh.T, lam, ddh.n_own))
        err_rs = np.abs(y_t - y_s).max() / max(1.0, np.abs(y_s).max())
        assert err_rs < 1e-5, err_rs

        def f(xy):
            r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
            return jnp.exp(-(omega**2) * r)

        b = helmholtz_rhs(fem, f)
        Y = ddh.rhs(b)
        out_t = gmres(ddh.action, Y, m=20, maxit=100, tol=1e-4)
        assert bool(out_t.success)
        ddh.use_transfer = False
        out_d = gmres(ddh.action, Y, m=20, maxit=100, tol=1e-4)
        xd, xt = np.asarray(out_d.x), np.asarray(out_t.x)
        rel = np.linalg.norm(xt - xd) / np.linalg.norm(xd)
        assert rel < 1e-3, rel
    finally:
        ddh.use_transfer = False


def test_ddh_two_domain_interface_exact():
    """With two subdomains (no cross points) and the mass split, every row of
    the lumped global system is satisfied except the two interface-endpoint
    DOFs (a defect inherent to the reference's transmission formulation)."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    a_nodal = np.ones(fem.ndof)

    def f(xy):
        r = (xy[..., 0] + 0.3) ** 2 + (xy[..., 1] - 0.2) ** 2
        return jnp.exp(-r / (2 * 0.2**2))

    b = helmholtz_rhs(fem, f)
    i = np.arange(nx)
    II, _ = np.meshgrid(i, i, indexing="ij")
    labels = (II // 4).T.reshape(-1)
    ddh = DDH(
        omega, a_nodal, fem, element_labels=labels, wh_maxit=12, rhs_split="mass"
    )
    Y = ddh.rhs(b)
    out = gmres(ddh.action, Y, m=20, maxit=100, tol=1e-6)
    U = np.asarray(ddh.postprocess(out.x, b))

    xd = _lumped_global_solution(mesh, fem, omega, a_nodal, b)
    n = fem.ndof
    # residual of the lumped system, excluding interface-endpoint rows
    from cuddhelmholtz_tpu.ops.mass import lumped_mass_diagonal

    stiff = make_stiffness_op(fem, quad=fem.basis.quadrature)
    mlump = jnp.asarray(lumped_mass_diagonal(fem))
    fs = FaceSpace(fem, mesh.boundary_edges)
    Hb = np.zeros(n)
    edge_meas = 0.5 * mesh.edge_lengths()
    qw = fem.basis.quadrature.w
    for k, e in enumerate(fs.faces):
        np.add.at(Hb, fs.proj[fs.face_dofs[k]], edge_meas[e] * qw)
    Hba = jnp.asarray(Hb)
    w2 = omega * omega

    u, v = jnp.asarray(U[:n]), jnp.asarray(U[n:])
    ru = apply_stiffness(stiff, u) - w2 * mlump * u - omega * Hba * v - jnp.asarray(b[:n])
    # identify interface and boundary DOFs
    gI = np.asarray(ddh.params.gI)
    counts = np.zeros(n, int)
    for p in range(ddh.n_domains):
        g = gI[p][gI[p] >= 0]
        counts[g] += 1
    iface = counts > 1
    bdry = np.zeros(n, bool)
    bdry[fs.proj] = True
    clean = ~(iface & bdry)
    rel_clean = np.linalg.norm(np.asarray(ru)[clean]) / np.linalg.norm(np.asarray(b[:n]))
    assert rel_clean < 5e-3, rel_clean


def test_ddh_solves_helmholtz_deg7():
    """End-to-end at n_basis = 8 (deg 7), the reference's other supported
    degree (DDH.cpp:333-344): 16x16-DOF subdomains of 2x2 elements.  The
    frequency is raised 4x over the drivers' nx/10 scaling to keep the
    CFL-limited cycle at nt = 800; the reference solution is an exact dense
    direct solve of the lumped global system (841 DOF -- no GMRES
    stagnation issues at high degree)."""
    nx, deg = 4, 7
    omega = 2 * np.pi * nx / 2.5
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    a_nodal = np.ones(fem.ndof)
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=16)
    assert ddh.n_domains == 4 and ddh.nt == 800

    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return omega**2 / np.pi * jnp.exp(-(omega**2) * r)

    b = helmholtz_rhs(fem, f)
    Y = ddh.rhs(b)
    out = gmres(ddh.action, Y, m=20, maxit=100, tol=1e-4)
    assert bool(out.success), np.asarray(out.res_norm)[: int(out.n_hist)]
    U = ddh.postprocess(out.x, b)

    # exact reference: densify the lumped coupled operator column by column
    from cuddhelmholtz_tpu.ops.mass import lumped_mass_diagonal

    n = fem.ndof
    stiff = make_stiffness_op(fem, quad=fem.basis.quadrature)
    mlump = jnp.asarray(lumped_mass_diagonal(fem) * a_nodal**2)
    fs = FaceSpace(fem, mesh.boundary_edges)
    Hb = np.zeros(n)
    edge_meas = 0.5 * mesh.edge_lengths()
    qw = fem.basis.quadrature.w
    for k, e in enumerate(fs.faces):
        np.add.at(Hb, fs.proj[fs.face_dofs[k]], edge_meas[e] * qw)
    Hba = jnp.asarray(Hb * a_nodal)
    w2 = omega * omega

    def matvec(Uc):
        u, v = Uc[:n], Uc[n:]
        Au = apply_stiffness(stiff, u) - w2 * mlump * u - omega * Hba * v
        Av = -(apply_stiffness(stiff, v) - w2 * mlump * v + omega * Hba * u)
        return jnp.concatenate([Au, Av])

    import jax

    A = np.asarray(jax.vmap(matvec, in_axes=1, out_axes=1)(jnp.eye(2 * n)))
    xd = np.linalg.solve(A, np.asarray(b))
    rel = np.linalg.norm(np.asarray(U) - xd) / np.linalg.norm(xd)
    assert rel < 0.15, rel


def test_ddh_io_maps_match_wave_path():
    """The precomputed rhs/postprocess linear maps (IOMaps) reproduce the
    wave-cycle rhs and postprocess to fp32 accuracy: after precompute, a
    whole solve runs without executing a single wave cycle."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 2.5  # keeps the CFL time grid at nt = 200
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    rng = np.random.default_rng(0)
    a_nodal = 1.0 + 0.3 * rng.random(fem.ndof)  # rough medium: all domains unique
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    assert ddh.nt == 200

    f = jnp.asarray(rng.standard_normal(2 * fem.ndof).astype(np.float32) * 1e-2)
    lam = jnp.asarray(rng.standard_normal(ddh.size).astype(np.float32))
    b_wave = np.asarray(ddh.rhs(f))
    u_wave = np.asarray(ddh.postprocess(lam, f))

    io = ddh.precompute_io_maps()
    assert io is not None and io.Pu.shape[0] == ddh.n_domains  # no dedup here
    ddh.use_transfer = True
    b_io = np.asarray(ddh.rhs(f))
    u_io = np.asarray(ddh.postprocess(lam, f))
    assert np.linalg.norm(b_io - b_wave) / np.linalg.norm(b_wave) < 2e-5
    assert np.linalg.norm(u_io - u_wave) / np.linalg.norm(u_wave) < 2e-5

    # memory guard: a tiny cap refuses and leaves the wave path in use
    ddh2 = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    assert ddh2.precompute_io_maps(max_bytes=1024) is None
    assert ddh2.io is None


def test_ddh_io_maps_uniform_medium_dedup():
    """The production accelerator default: a uniform medium, where the
    identical-subdomain dedup is ACTIVE (nu < ndom) and io-map application
    goes through the grouped combine -- the path the rough-medium test above
    deliberately bypasses."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 2.5
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    ddh = DDH(omega, np.ones(fem.ndof), fem, nx=nx, ny=nx, block_size=8)

    rng = np.random.default_rng(1)
    f = jnp.asarray(rng.standard_normal(2 * fem.ndof).astype(np.float32) * 1e-2)
    lam = jnp.asarray(rng.standard_normal(ddh.size).astype(np.float32))
    b_wave = np.asarray(ddh.rhs(f))
    u_wave = np.asarray(ddh.postprocess(lam, f))

    io = ddh.precompute_io_maps()
    assert io is not None and io.Pu.shape[0] < ddh.n_domains  # dedup active
    ddh.use_transfer = True
    b_io = np.asarray(ddh.rhs(f))
    u_io = np.asarray(ddh.postprocess(lam, f))
    assert np.linalg.norm(b_io - b_wave) / np.linalg.norm(b_wave) < 2e-5
    assert np.linalg.norm(u_io - u_wave) / np.linalg.norm(u_wave) < 2e-5


def test_ddh_precompute_cache_roundtrip(tmp_path):
    """``prepare`` persists the transfer/io maps keyed by config hash; a
    fresh DDH with the same setup loads them (no probe cycles) and produces
    bit-identical action/rhs/postprocess results."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 2.5
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    rng = np.random.default_rng(2)
    a_nodal = 1.0 + 0.1 * rng.random(fem.ndof)
    cache = str(tmp_path / "cache")

    ddh1 = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    stats1 = ddh1.prepare(cache_dir=cache, want_io=True)
    assert not stats1["cache_hit"] and "transfer_first_chunk_seconds" in stats1
    assert ddh1.use_transfer and ddh1.io is not None

    ddh2 = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    assert ddh2.setup_cache_key() == ddh1.setup_cache_key()
    stats2 = ddh2.prepare(cache_dir=cache, want_io=True)
    assert stats2["cache_hit"]
    assert ddh2.use_transfer and ddh2.io is not None
    assert (ddh2.route is None) == (ddh1.route is None)

    lam = jnp.asarray(rng.standard_normal(ddh1.size).astype(np.float32))
    f = jnp.asarray(rng.standard_normal(2 * fem.ndof).astype(np.float32) * 1e-2)
    np.testing.assert_array_equal(
        np.asarray(ddh2.action(lam)), np.asarray(ddh1.action(lam))
    )
    np.testing.assert_array_equal(np.asarray(ddh2.rhs(f)), np.asarray(ddh1.rhs(f)))
    np.testing.assert_array_equal(
        np.asarray(ddh2.postprocess(lam, f)), np.asarray(ddh1.postprocess(lam, f))
    )

    # a different setup must MISS (different hash), not collide
    ddh3 = DDH(omega * 1.01, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    assert ddh3.setup_cache_key() != ddh1.setup_cache_key()
    assert not ddh3.try_load_precomputed(cache)


def test_group_apply_majority_split_matches_fallback():
    """The majority-split group apply (one shared matmul + recursive
    special-row correction) equals the one-hot/gather fallbacks and the
    per-domain reference loop."""
    from cuddhelmholtz_tpu.solvers.ddh import _group_apply, _iomaps_split

    rng = np.random.default_rng(7)
    nu, ndom, out_d, in_d = 5, 64, 8, 16
    inv = np.zeros(ndom, dtype=np.int64)
    inv[:12] = rng.integers(1, nu, 12)  # group 0 holds the majority
    M = jnp.asarray(rng.standard_normal((nu, out_d, in_d)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((ndom, in_d)), jnp.float32)
    onehot = jnp.asarray(
        (inv[None, :] == np.arange(nu)[:, None]).astype(np.float32)
    )
    want = np.stack([np.asarray(M)[inv[d]] @ np.asarray(x)[d] for d in range(ndom)])

    group, maj, spec = _iomaps_split(inv)
    assert spec is not None and spec.shape[0] == 12
    y_split = np.asarray(_group_apply(M, x, onehot, group, maj, spec))
    y_fall = np.asarray(_group_apply(M, x, onehot))
    np.testing.assert_allclose(y_split, want, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(y_fall, want, rtol=2e-5, atol=1e-5)

    # no-majority partitions return None metadata (fallback path stays)
    inv2 = np.arange(ndom) % nu
    g2, m2, s2 = _iomaps_split(inv2)
    assert g2 is None and m2 is None and s2 is None


def _jittered_ddh(nx=8, nt=60):
    """Structured partition of a jittered mesh: every subdomain assembles a
    DIFFERENT stiffness matrix (the per-domain S path)."""
    mesh0 = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    rng = np.random.default_rng(3)
    verts = mesh0.vertices.copy()
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (
        np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12
    )
    verts[interior] += 0.15 * (2.0 / nx) * rng.uniform(-1, 1, (interior.sum(), 2))
    mesh = Mesh2D.from_vertices(verts, mesh0.elem_vertices)
    fem = H1Space(mesh, Basis(4))
    return DDH(
        2 * np.pi * nx / 2.5, np.ones(fem.ndof), fem, nx=nx, ny=nx,
        block_size=8, nt_override=nt,
    )


def test_dedup_uniform_medium_groups_match_host_data():
    """Shared S: the groups are exactly the distinct rows of the host cycle
    data, and ``transfer_nu`` is their count."""
    nx = 8
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(4))
    ddh = DDH(2 * np.pi * nx / 2.5, np.ones(fem.ndof), fem, nx=nx, ny=nx,
              block_size=8, nt_override=20)
    assert ddh.shared_S
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    key = np.concatenate(
        [f32(ddh._Ha_np), f32(ddh._mi_np), f32(ddh._a2wf_np), ddh._Hf_np,
         ddh._fslot_np.astype(np.float64)], axis=1,
    )
    n_unique = np.unique(key, axis=0).shape[0]
    uidx, inv, nu = ddh._domain_groups()
    assert 1 < nu == n_unique < ddh.n_domains
    for g in range(nu):
        members = np.nonzero(inv == g)[0]
        assert np.all(key[members] == key[members[0]])
    ddh.precompute_transfer()
    assert ddh.transfer_stats["transfer_nu"] == n_unique


def test_dedup_identical_subdomains_form_one_group():
    """Per-domain S: domains whose host cycle data (stiffness bytes
    included) are identical collapse into ONE group, and the transfer probes
    run for that one domain only; distinct stiffness matrices stay apart."""
    from cuddhelmholtz_tpu.solvers.ddh import _row_ids

    ddh = _jittered_ddh(nt=20)
    assert not ddh.shared_S and ddh.params.S.ndim == 3
    assert ddh._domain_groups()[2] == ddh.n_domains  # all distinct
    S = np.asarray(ddh.params.S)
    np.testing.assert_array_equal(_row_ids(S[[0, 1, 0, 2, 1]]), [0, 1, 0, 2, 1])

    # make every domain a copy of domain 0 on the host side
    ddh._domain_groups_cache = None
    ddh._S_ids = np.zeros(ddh.n_domains, np.int64)
    for name in ("_Ha_np", "_mi_np", "_a2wf_np", "_Hf_np", "_fslot_np"):
        a = getattr(ddh, name)
        setattr(ddh, name, np.broadcast_to(a[:1], a.shape).copy())
    uidx, inv, nu = ddh._domain_groups()
    assert nu == 1 and np.all(inv == 0) and list(uidx) == [0]
    T = ddh.precompute_transfer()
    assert ddh.transfer_stats["transfer_nu"] == 1 and T.shape[0] == 1


def test_probe_compile_payload_no_large_constants(monkeypatch):
    """Probe-chunk jits must take the per-domain arrays as ARGUMENTS: a
    closed-over S stack is serialized into the program as a dense literal,
    which at scale makes programs of hundreds of MB.  Spy on jax.jit and
    assert every traced probe program lowers to far less text than the S
    stack itself would occupy as an embedded literal."""
    import jax

    from cuddhelmholtz_tpu.mesh.io import load_unstructured_square
    from cuddhelmholtz_tpu.solvers import ddh as ddh_mod
    from cuddhelmholtz_tpu.spaces.ensemble import coordinate_bisection_labels

    mesh = load_unstructured_square()
    labels, nd = coordinate_bisection_labels(mesh, 8)
    fem = H1Space(mesh, Basis(4))
    d = ddh_mod.DDH(
        2 * np.pi * 0.8, np.ones(fem.ndof), fem,
        element_labels=labels, n_domains=nd, nt_override=20,
    )
    assert d.params.S.ndim == 3  # per-domain stiffness: the dangerous case
    s_bytes = int(np.prod(d.params.S.shape)) * 4

    real_jit = jax.jit
    sizes = []

    def spy_jit(f=None, **kw):
        if f is None:
            return lambda g: spy_jit(g, **kw)
        jf = real_jit(f, **kw)

        def wrapped(*a, **k):
            sizes.append(len(jf.lower(*a, **k).as_text()))
            return jf(*a, **k)

        return wrapped

    monkeypatch.setattr(jax, "jit", spy_jit)
    d.precompute_transfer()
    d.precompute_io_maps()
    assert sizes, "no probe jit was traced"
    # an embedded S literal alone costs >= 2 text chars/byte; argument-passed
    # state keeps the whole program orders of magnitude below that
    assert max(sizes) < min(s_bytes, 1 << 20), (max(sizes), s_bytes)
