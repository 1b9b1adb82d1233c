"""Pin the production DDH against a NumPy transliteration of the reference.

``cuddhelmholtz_tpu/solvers/ddh_oracle.py`` rewrites ``/root/reference/source/DDH.cpp:111-321,
323-609`` directly (reference numbering, face-first permutation, fp32,
full-F forcing).  These tests assert that the production path
(own-slot lambda layout, dense assembled subdomain stiffness, batched scan
cycle) computes the SAME operator: per-apply outputs to fp32 tolerance and
matching lambda-GMRES residual histories.  This proves the remaining ~10%
solution defect vs the global discretization (test_ddh.py) is inherent to
the reference formulation, not implementation drift, and locks convergence
behaviour against refactors.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuddhelmholtz_tpu.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu.solvers.ddh import DDH
from cuddhelmholtz_tpu.spaces.h1 import H1Space
from cuddhelmholtz_tpu.utils.basis import Basis

from cuddhelmholtz_tpu.solvers.ddh_oracle import DDHOracle, gmres_numpy

def _make_pair(nx=8, deg=3, labels=None, seed=0):
    # 4x the reference's nx/10 frequency scaling: T = 2 pi / omega shrinks so
    # the CFL-limited time grid is nt = 200 instead of 800, keeping the NumPy
    # oracle fast.  dt stays at the reference's stability bound (leapfrog at
    # the reduced nt of a naive nt_override diverges and amplifies rounding).
    omega = 2 * np.pi * nx / 2.5
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    rng = np.random.default_rng(seed)
    a_nodal = 1.0 + 0.3 * rng.random(fem.ndof)  # rough medium: exercises a(x)
    if labels is None:
        ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
    else:
        ddh = DDH(omega, a_nodal, fem, element_labels=labels)
    oracle = DDHOracle(omega, a_nodal, fem, ddh.efem)
    assert oracle.nt == ddh.nt == 200 and abs(oracle.dt - ddh.dt) < 1e-14
    return mesh, fem, omega, a_nodal, ddh, oracle


def _maps(ddh, oracle):
    """Vector maps between the reference numbering and the own-slot layout."""
    newid = ddh.lambda_newid  # reference id -> production id
    n_ref = oracle.n_lambda
    n_prod = ddh.n_lambda
    assert newid.shape[0] == n_ref and np.unique(newid).size == n_ref

    def to_prod(l_ref):
        z = np.zeros(2 * n_prod, dtype=np.float32)
        z[newid] = l_ref[:n_ref]
        z[n_prod + newid] = l_ref[n_ref:]
        return z

    def from_prod(l_prod):
        l_prod = np.asarray(l_prod)
        return np.concatenate([l_prod[newid], l_prod[n_prod + newid]])

    return to_prod, from_prod


@pytest.fixture(scope="module")
def structured_pair():
    return _make_pair()


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_oracle_action_matches(structured_pair):
    _, _, _, _, ddh, oracle = structured_pair
    to_prod, from_prod = _maps(ddh, oracle)
    rng = np.random.default_rng(1)
    for trial in range(2):
        l_ref = rng.standard_normal(2 * oracle.n_lambda).astype(np.float32)
        want = oracle.action(l_ref)
        got = from_prod(ddh.action(jnp.asarray(to_prod(l_ref))))
        assert _rel(got, want) < 2e-4, (trial, _rel(got, want))


def test_oracle_rhs_matches(structured_pair):
    _, fem, omega, _, ddh, oracle = structured_pair
    _, from_prod = _maps(ddh, oracle)

    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return omega**2 * jnp.exp(-(omega**2) * r)

    b = helmholtz_rhs(fem, f)
    want = oracle.rhs(np.asarray(b))
    got = from_prod(ddh.rhs(b))
    assert _rel(got, want) < 2e-4, _rel(got, want)


def test_oracle_postprocess_matches(structured_pair):
    _, fem, omega, _, ddh, oracle = structured_pair
    to_prod, _ = _maps(ddh, oracle)
    rng = np.random.default_rng(2)

    def f(xy):
        r = (xy[..., 0] - 0.2) ** 2 + (xy[..., 1] + 0.1) ** 2
        return jnp.exp(-(omega**2) * r)

    b = helmholtz_rhs(fem, f)
    l_ref = rng.standard_normal(2 * oracle.n_lambda).astype(np.float32)
    want = oracle.postprocess(l_ref, np.asarray(b))
    got = np.asarray(ddh.postprocess(jnp.asarray(to_prod(l_ref)), b))
    assert _rel(got, want) < 2e-4, _rel(got, want)


def test_oracle_gmres_history_matches(structured_pair):
    """Same solver (NumPy CGS2 GMRES) on both operators: the lambda-GMRES
    residual histories must coincide, pinning convergence RATE (a subtle
    phase/filter bug that merely slows convergence would fail here)."""
    _, fem, omega, _, ddh, oracle = structured_pair
    to_prod, from_prod = _maps(ddh, oracle)

    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return omega**2 * jnp.exp(-(omega**2) * r)

    b = helmholtz_rhs(fem, f)
    b_ref = oracle.rhs(np.asarray(b))

    def mv_prod(l_ref):
        return from_prod(ddh.action(jnp.asarray(to_prod(l_ref))))

    _, hist_o, nmv_o = gmres_numpy(oracle.action, b_ref, m=10, maxit=4, tol=1e-6)
    _, hist_p, nmv_p = gmres_numpy(mv_prod, b_ref, m=10, maxit=4, tol=1e-6)
    assert nmv_o == nmv_p
    assert hist_o.shape == hist_p.shape
    np.testing.assert_allclose(hist_p, hist_o, rtol=2e-3)


def test_oracle_matches_on_irregular_partition():
    """Same agreement on a non-square partition (per-domain stiffness path,
    ragged face counts) — beyond what the reference itself supports."""
    nx = 8
    i, j = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    # 3 uneven strips: exercises per-domain sizes, ragged cmap
    labels = np.minimum((i // 3), 2).T.reshape(-1)
    _, _, _, _, ddh, oracle = _make_pair(labels=labels, seed=3)
    to_prod, from_prod = _maps(ddh, oracle)
    rng = np.random.default_rng(4)
    l_ref = rng.standard_normal(2 * oracle.n_lambda).astype(np.float32)
    want = oracle.action(l_ref)
    got = from_prod(ddh.action(jnp.asarray(to_prod(l_ref))))
    assert _rel(got, want) < 2e-4, _rel(got, want)


def test_oracle_action_matches_deg7():
    """n_basis = 8 (deg 7), the reference's other supported degree
    (DDH.cpp:333-344, NB template in {4, 8}): 16x16-DOF subdomains hold
    2x2 elements.  Raised frequency keeps the CFL-limited time grid at
    nt = 400 so the NumPy oracle stays fast."""
    nx, deg = 4, 7
    omega = 2 * np.pi * nx / 1.25
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(deg + 1))
    rng = np.random.default_rng(5)
    a_nodal = 1.0 + 0.3 * rng.random(fem.ndof)
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=16)
    assert ddh.n_domains == 4
    oracle = DDHOracle(omega, a_nodal, fem, ddh.efem)
    assert oracle.nt == ddh.nt == 400 and abs(oracle.dt - ddh.dt) < 1e-14
    to_prod, from_prod = _maps(ddh, oracle)
    l_ref = rng.standard_normal(2 * oracle.n_lambda).astype(np.float32)
    want = oracle.action(l_ref)
    got = from_prod(ddh.action(jnp.asarray(to_prod(l_ref))))
    assert _rel(got, want) < 2e-4, _rel(got, want)


@pytest.fixture(scope="module")
def cycle_pairs():
    """(ddh, oracle) with a shared stiffness (uniform grid, rough medium) and
    with per-domain stiffness matrices (jittered grid)."""
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 2.5
    rng = np.random.default_rng(6)
    mesh0 = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    verts = mesh0.vertices.copy()
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (
        np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12
    )
    verts[interior] += 0.15 * (2.0 / nx) * rng.uniform(-1, 1, (interior.sum(), 2))
    pairs = {}
    for kind, mesh in (("shared", mesh0),
                       ("per_domain", Mesh2D.from_vertices(verts, mesh0.elem_vertices))):
        fem = H1Space(mesh, Basis(deg + 1))
        a_nodal = 1.0 + 0.3 * rng.random(fem.ndof)
        ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8)
        assert ddh.shared_S == (kind == "shared")
        pairs[kind] = (ddh, DDHOracle(omega, a_nodal, fem, ddh.efem))
    return pairs


@pytest.mark.parametrize("kind", ["shared", "per_domain"])
@pytest.mark.parametrize("pad_rows", [0, 3])
@pytest.mark.parametrize("wh_maxit", [1, 5])
def test_wave_cycle_matches_oracle(cycle_pairs, kind, pad_rows, wh_maxit):
    """The production ``_wave_cycle_xla`` (dense assembled stiffness, at the
    pinned ``PRECISION``) against the reference's inline sum-factorised
    cycle, on a subset of real subdomains; zero padding rows stay zero."""
    from cuddhelmholtz_tpu.solvers.ddh import PRECISION
    from cuddhelmholtz_tpu.solvers.ddh_oracle import compare_wave_cycle

    assert PRECISION == "highest"
    ddh, oracle = cycle_pairs[kind]
    doms = [0, 5, 10, 15]
    err_u, err_v, pad_max = compare_wave_cycle(
        ddh, oracle, doms, wh_maxit=wh_maxit, pad_rows=pad_rows, seed=wh_maxit
    )
    assert err_u < 2e-4 and err_v < 2e-4, (err_u, err_v)
    assert pad_max == 0.0
