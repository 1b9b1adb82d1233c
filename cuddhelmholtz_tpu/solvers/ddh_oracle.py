"""Reference-oracle transliteration of the CUDA DDH kernel.

A direct NumPy rewrite of ``/root/reference/source/DDH.cpp`` — the setup
(``DDH.cpp:323-609``) and the ``ddh_action`` kernel (``DDH.cpp:111-321``) —
with the reference's exact semantics:

  * face-first DOF permutation per subdomain (``DDH.cpp:442-481``),
  * dual-trace B table with last-write-wins at corner slots
    (``DDH.cpp:408-440``),
  * the FULL global forcing fed to every subdomain (``DDH.cpp:208-212``),
  * per-element collocated stiffness applied inside the time loop
    (``DDH.cpp:60-109``), fp32 state throughout.

Independent of the production path in ``cuddhelmholtz_tpu.solvers.ddh``
everywhere it matters: no shared stiffness assembly, no own-slot lambda
layout, no transfer matrices — only the EnsembleSpace index tables (which
have their own invariant tests) are reused.  Domains are batched along a
leading axis purely for speed; they are independent in the reference kernel
(one CUDA block each), so this changes no semantics.

Used by ``tests/test_ddh_oracle.py`` to pin the production apply and the
lambda-GMRES convergence behaviour against the reference algorithm, and by
``chip_smoke.py`` as the plain reference of the wave cycle on the device.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
WH_MAXIT = 5  # DDH.cpp:136


class DDHOracle:
    """Reference-faithful DDH operator (NumPy, fp32, reference numbering)."""

    def __init__(self, omega, a_nodal, space, efem, nt_override=None):
        self.space = space
        self.efem = efem
        self.omega = float(omega)
        self.g_ndof = space.ndof
        nb = space.n_basis
        self.nb = nb
        ndom = efem.n_domains
        self.n_domains = ndom
        mesh = space.mesh

        # --- WaveHoltz time grid + filter + phases (DDH.cpp:360-386) --------
        T = 2 * np.pi / omega
        h = mesh.min_h()
        dt = 0.2 * 0.5 * h / (nb * nb)
        nt = int(np.ceil(T / dt)) if nt_override is None else int(nt_override)
        dt = T / nt
        self.nt, self.dt = nt, dt
        k = np.arange(nt + 1)
        filt = dt * (omega / np.pi) * (np.cos(omega * k * dt) - 0.25)
        filt[0] *= 0.5
        filt[nt] *= 0.5
        self.wh_filter = filt.astype(F32)
        th = 0.5 * np.arange(2 * nt + 1) * dt
        self.cs = (-np.cos(omega * th)).astype(F32)
        self.sn = (np.sin(omega * th)).astype(F32)

        # --- lambda numbering: B table, last-write-wins (DDH.cpp:408-440) ---
        cm = efem.cmap
        n_shared = efem.n_shared_dofs
        self.n_lambda = 2 * n_shared
        mx_fdof = efem.mx_fdof
        B = np.full((ndom, mx_fdof, 2), -1, dtype=np.int64)
        for kk in range(n_shared):
            s0, s1, f0, f1 = (int(v) for v in cm[kk])
            B[s0, f0, 0] = kk
            B[s0, f0, 1] = n_shared + kk
            B[s1, f1, 0] = n_shared + kk
            B[s1, f1, 1] = kk
        self.B = B

        # --- face-first DOF permutation (DDH.cpp:442-481) --------------------
        sizes, fsizes = efem.sizes, efem.fsizes
        mx_dof = efem.mx_ndof
        self.mx_dof = mx_dof
        perm = np.full((ndom, mx_dof), -1, dtype=np.int64)
        inv_perm = np.full((ndom, mx_dof), -1, dtype=np.int64)
        for p in range(ndom):
            ndof, fdof = int(sizes[p]), int(fsizes[p])
            pp = set()
            ll = 0
            for ll in range(fdof):
                j = int(efem.pI[p, ll])
                pp.add(j)
                perm[p, ll] = j
            ll = fdof
            for i in range(ndof):
                if i in pp:
                    continue
                perm[p, ll] = i
                ll += 1
            for i in range(ndof):
                inv_perm[p, perm[p, i]] = i

        # oracle slot ll of domain p holds the EnsembleSpace local DOF
        # perm[p, ll] (the production DDH's slot index); -1 past ndof
        self.perm = perm

        # permuted index tables (DDH.cpp:483-510)
        gI = np.full((ndom, mx_dof), 0, dtype=np.int64)
        valid = np.zeros((ndom, mx_dof), dtype=bool)
        mx_el = efem.mx_elems
        # sI[p, el, l, k] (l = eta node, k = xi node), matching the reference
        # column-major sI(k, l, el, subsp)
        sI = np.zeros((ndom, mx_el, nb, nb), dtype=np.int64)
        for p in range(ndom):
            ndof = int(sizes[p])
            gI[p, :ndof] = efem.gI[p, perm[p, :ndof]]
            valid[p, :ndof] = True
            nel = int(efem.n_elems[p])
            sI[p, :nel] = inv_perm[p, efem.local_dofs[p, :nel]]
        self.gI, self.valid = gI, valid

        # --- subspace operators (DDH.cpp:512-608) ----------------------------
        quad = space.basis.quadrature
        w = quad.w
        self.D = space.basis.derivative_matrix.astype(F32)  # D[q, i]
        metrics = mesh.element_metrics(quad)
        J = metrics.jacobians  # (nel, k, l, a, b): J[..., a, b] = dx_a/dxi_b
        detJ = metrics.measures  # (nel, k, l)

        # geometric factors G(k, l, el) as float3 (init_geom_factors,
        # DDH.cpp:15-58); stored [p, el, l, k] to match the kernel state layout
        W = np.outer(w, w)  # W[k, l] = w_k w_l
        X_xi, X_eta = J[..., 0, 0], J[..., 0, 1]
        Y_xi, Y_eta = J[..., 1, 0], J[..., 1, 1]
        gx = (W * (Y_eta**2 + X_eta**2) / detJ).astype(F32)  # (nel, k, l)
        gy = (-W * (Y_xi * Y_eta + X_xi * X_eta) / detJ).astype(F32)
        gz = (W * (Y_xi**2 + X_xi**2) / detJ).astype(F32)
        gels = np.maximum(efem.elems, 0)  # (ndom, mx_el)
        emask = (efem.elems >= 0)[:, :, None, None]
        self.Gx = np.where(emask, gx[gels].transpose(0, 1, 3, 2), 0).astype(F32)
        self.Gy = np.where(emask, gy[gels].transpose(0, 1, 3, 2), 0).astype(F32)
        self.Gz = np.where(emask, gz[gels].transpose(0, 1, 3, 2), 0).astype(F32)
        self.sI = sI
        self.n_elems = efem.n_elems.copy()

        # subdomain lumped mass m (DDH.cpp:570-584), element loop order
        m = np.zeros((ndom, mx_dof), dtype=F32)
        for p in range(ndom):
            for el in range(int(efem.n_elems[p])):
                g_el = int(efem.elems[p, el])
                for l in range(nb):
                    for kk in range(nb):
                        m[p, sI[p, el, l, kk]] += F32(
                            w[kk] * w[l] * detJ[g_el, kk, l]
                        )
        self.m = m

        # global lumped inverse mass (DDH.cpp:559-568)
        mi = np.zeros(space.ndof)
        np.add.at(
            mi,
            space.dofs.reshape(-1),
            (W.T[None] * detJ.transpose(0, 2, 1)).reshape(-1),
        )
        mi = 1.0 / mi
        self.gmi = np.where(valid, mi[gI], 0.0).astype(F32)

        a_nodal = np.asarray(a_nodal, dtype=np.float64)
        self.a = np.where(valid, a_nodal[gI], 0.0).astype(F32)

        # face mass H (DDH.cpp:593-607), indexed by face-space DOF id (== the
        # leading subspace slots under the face-first permutation)
        H = np.zeros((ndom, mx_dof), dtype=F32)
        edge_meas = 0.5 * mesh.edge_lengths()
        for p in range(ndom):
            for f in range(int(efem.n_faces[p])):
                g_f = int(efem.faces[p, f])
                ds = edge_meas[g_f]
                for i in range(nb):
                    H[p, efem.fI[p, f, i]] += F32(ds * w[i])
        self.H = H
        self.fsizes = fsizes.copy()
        self.sizes = sizes.copy()

    # ------------------------------------------------------------------ kernel

    def _stiffness(self, u, doms):
        """z += S u per subdomain: the inline collocated sum-factorised apply
        (``stiffness``, DDH.cpp:60-109), batched over the domains ``doms``
        (rows of ``u``) and their elements."""
        D = self.D
        sI = self.sI[doms]  # (nd, nel, l, k)
        nd = len(doms)
        dom = np.arange(nd, dtype=np.int64)[:, None, None, None]
        U = u[dom, sI]  # U[p, el, l, i] = u[p, sI[p, el, l, i]]
        Ux = np.einsum("ki,peli->pelk", D, U)  # d/dxi at (l, k)
        Uy = np.einsum("li,peik->pelk", D, U)  # d/deta at (l, k)
        fx = self.Gx[doms] * Ux + self.Gy[doms] * Uy
        fy = self.Gy[doms] * Ux + self.Gz[doms] * Uy
        Su = np.einsum("ik,peli->pelk", D, fx) + np.einsum("il,peik->pelk", D, fy)
        z = np.zeros_like(u)
        flat = (dom[:, :, 0, 0] * u.shape[1] + sI.reshape(nd, -1))
        np.add.at(z.reshape(-1), flat.reshape(-1), Su.reshape(-1))
        return z

    def _inv_mi(self, doms):
        with np.errstate(divide="ignore"):
            a, m = self.a[doms], self.m[doms]
            return np.where(
                self.valid[doms], F32(1.0) / (a * a * m), F32(0)
            ).astype(F32)

    def _face_mass(self, doms):
        in_f = np.arange(self.mx_dof)[None, :] < self.fsizes[doms][:, None]
        return np.where(in_f, self.H[doms], F32(0)).astype(F32)

    def cycle(self, F, G, doms=None, wh_maxit=WH_MAXIT):
        """The ``wh_maxit`` x nt leapfrog WaveHoltz cycle (DDH.cpp:237-293)
        of the domains ``doms`` (default: all) from the forcing ``F, G``
        ((len(doms), mx_dof), oracle slot layout).  Returns the filtered
        ``(u, v)``, ``v`` not yet divided by omega."""
        doms = np.arange(self.n_domains) if doms is None else np.asarray(doms)
        dt = F32(self.dt)
        half_dt = F32(0.5) * dt
        inv_mi = self._inv_mi(doms)
        Hia = (self._face_mass(doms) * self.a[doms]).astype(F32)  # DDH.cpp:233
        F = np.asarray(F, dtype=F32)
        G = np.asarray(G, dtype=F32)
        u = np.zeros((len(doms), self.mx_dof), dtype=F32)
        v = np.zeros_like(u)
        cs, sn, filt = self.cs, self.sn, self.wh_filter
        for _ in range(wh_maxit):
            dK = filt[0]
            p = u.copy()
            q = v.copy()
            u = u * dK
            v = v * dK
            for it in range(1, self.nt + 1):
                z = self._stiffness(p, doms)
                z -= Hia * q
                dq = (z + cs[2 * it - 2] * F + sn[2 * it - 2] * G) * inv_mi
                p_half = p - half_dt * q
                q_half = q + half_dt * dq
                p = p - dt * q_half
                z = self._stiffness(p_half, doms)
                z -= Hia * q_half
                dq = (z + cs[2 * it - 1] * F + sn[2 * it - 1] * G) * inv_mi
                q = q + dt * dq
                dK = filt[it]
                u = u + dK * p
                v = v + dK * q
        return u, v

    def _kernel(self, x, lam, want_y, want_update, wh_maxit=WH_MAXIT):
        """The ddh_action kernel (DDH.cpp:111-321) on all subdomains."""
        ndom, mx = self.n_domains, self.mx_dof
        g_ndof = self.g_ndof
        n_lambda = self.n_lambda
        rw = F32(1.0) / F32(self.omega)

        tid = np.arange(mx)
        in_dof = self.valid  # tid < ndof
        in_f = tid[None, :] < self.fsizes[:, None]  # tid < fdof

        a = self.a
        m = self.m
        Hi = self._face_mass(np.arange(ndom))

        F = np.zeros((ndom, mx), dtype=F32)
        G = np.zeros((ndom, mx), dtype=F32)
        if x is not None:
            x = np.asarray(x)
            F = np.where(in_dof, x[self.gI].astype(F32), F32(0))
            G = np.where(in_dof, x[g_ndof + self.gI].astype(F32), F32(0))

        lam_t = np.zeros((ndom, mx), dtype=F32)
        mu_t = np.zeros((ndom, mx), dtype=F32)
        if lam is not None:
            lam = np.asarray(lam, dtype=F32)
            g_lambda, g_mu = lam[:n_lambda], lam[n_lambda:]
            B0 = self.B[:, :, 0]
            hasl = np.zeros((ndom, mx), dtype=bool)
            hasl[:, : B0.shape[1]] = in_f[:, : B0.shape[1]] & (B0 >= 0)
            idx = np.zeros((ndom, mx), dtype=np.int64)
            idx[:, : B0.shape[1]] = np.maximum(B0, 0)
            lam_t = np.where(hasl, g_lambda[idx], F32(0)).astype(F32)
            mu_t = np.where(hasl, g_mu[idx], F32(0)).astype(F32)
            F = F + Hi * lam_t
            G = G + Hi * mu_t

        u, v = self.cycle(F, G, wh_maxit=wh_maxit)
        v = v * rw

        y = None
        if want_y:
            y = np.zeros(2 * g_ndof, dtype=np.float64)
            M = (m * self.gmi).astype(F32)
            mu_val = (M * u).astype(F32)
            mv_val = (M * v).astype(F32)
            np.add.at(y, np.where(in_dof, self.gI, 0), np.where(in_dof, mu_val, 0))
            np.add.at(
                y,
                g_ndof + np.where(in_dof, self.gI, 0),
                np.where(in_dof, mv_val, 0),
            )

        update = None
        if want_update:
            update = np.zeros(2 * n_lambda, dtype=F32)
            B1 = self.B[:, :, 1]
            hasu = in_f[:, : B1.shape[1]] & (B1 >= 0)
            S2 = F32(2.0) * a[:, : B1.shape[1]] * F32(self.omega)
            lam_u = -lam_t[:, : B1.shape[1]] - S2 * v[:, : B1.shape[1]]
            mu_u = -mu_t[:, : B1.shape[1]] + S2 * u[:, : B1.shape[1]]
            tgt = B1[hasu]
            update[tgt] = lam_u[hasu]
            update[n_lambda + tgt] = mu_u[hasu]

        return y, update

    # ----------------------------------------------------------------- api

    def action(self, lam):
        """lambda - S(lambda) (DDH.cpp:611-639)."""
        _, update = self._kernel(None, lam, want_y=False, want_update=True)
        return np.asarray(lam, dtype=F32) - update

    def rhs(self, f):
        """Substructured rhs from the volume forcing (DDH.cpp:641-667)."""
        _, update = self._kernel(f, None, want_y=False, want_update=True)
        return update

    def postprocess(self, lam, f):
        """Recover [u; v] (DDH.cpp:669-695)."""
        y, _ = self._kernel(f, lam, want_y=True, want_update=False)
        return y


def compare_wave_cycle(ddh, oracle, doms, wh_maxit=WH_MAXIT, precision=None,
                       pad_rows=0, seed=0):
    """Run the production ``_wave_cycle_xla`` of ``ddh`` on its subdomains
    ``doms`` (followed by ``pad_rows`` all-zero padding rows, as a sharded
    batch carries) and this oracle's cycle on the same random forcing.

    Returns ``(err_u, err_v, pad_max)``: the max-abs errors of u and v
    relative to the oracle's max-abs values, and the largest magnitude the
    production cycle left in its padding rows (must be 0)."""
    import jax
    import jax.numpy as jnp

    from .ddh import PRECISION, _wave_cycle_xla

    precision = PRECISION if precision is None else precision
    doms = np.asarray(doms)
    nd = len(doms)
    rng = np.random.default_rng(seed)
    valid = oracle.valid[doms]
    Fo = np.where(valid, rng.standard_normal(valid.shape), 0.0).astype(F32)
    Go = np.where(valid, rng.standard_normal(valid.shape), 0.0).astype(F32)
    # oracle slot ll of row r is production slot perm[doms[r], ll]
    rows = np.broadcast_to(np.arange(nd)[:, None], valid.shape)[valid]
    cols = oracle.perm[doms][valid]
    Fp = np.zeros((nd + pad_rows, ddh.pad), F32)
    Gp = np.zeros_like(Fp)
    Fp[rows, cols] = Fo[valid]
    Gp[rows, cols] = Go[valid]

    p = ddh.params
    di = jnp.asarray(doms)

    def sub(a):
        a = a[di]
        return jnp.concatenate([a, jnp.zeros((pad_rows,) + a.shape[1:], a.dtype)])

    p2 = p._replace(
        S=p.S if p.S.ndim == 2 else sub(p.S), Ha=sub(p.Ha), inv_mi=sub(p.inv_mi)
    )
    cyc = jax.jit(_wave_cycle_xla, static_argnums=(3, 4))
    u, v = jax.block_until_ready(
        cyc(p2, jnp.asarray(Fp), jnp.asarray(Gp), int(wh_maxit), precision)
    )
    u, v = np.asarray(u), np.asarray(v)
    uo, vo = oracle.cycle(Fo, Go, doms, wh_maxit)

    def err(x, xo):
        got = np.zeros_like(xo)
        got[valid] = x[rows, cols]
        return float(np.abs(got - xo).max() / max(np.abs(xo).max(), 1e-30))

    pad_max = float(np.abs(np.concatenate([u[nd:], v[nd:]])).max()) if pad_rows else 0.0
    return err(u, uo), err(v, vo), pad_max


def gmres_numpy(matvec, b, m=20, maxit=100, tol=1e-4):
    """Plain restarted GMRES(m) with CGS2 + Givens in NumPy fp32 — the same
    algorithm as ``cuddhelmholtz_tpu.solvers.gmres.gmres`` so residual
    histories from the two operators are directly comparable."""
    b = np.asarray(b, dtype=F32)
    n = b.shape[0]
    x = np.zeros(n, dtype=F32)
    bnrm = np.linalg.norm(b)
    r = b - matvec(x)
    hist = [float(np.linalg.norm(r))]
    nmv = 1
    for _ in range(maxit - 1):
        r_nrm = np.linalg.norm(r)
        if r_nrm < tol * bnrm or r_nrm == 0.0:
            break
        V = np.zeros((m + 1, n), dtype=F32)
        V[0] = r / r_nrm
        Hm = np.zeros((m + 1, m), dtype=F32)
        cs_g = np.zeros(m, dtype=F32)
        sn_g = np.zeros(m, dtype=F32)
        eta = np.zeros(m + 1, dtype=F32)
        eta[0] = r_nrm
        k_used = 0
        for k in range(m):
            w = matvec(V[k])
            nmv += 1
            h = V[: k + 1] @ w
            w = w - V[: k + 1].T @ h
            h2 = V[: k + 1] @ w
            w = w - V[: k + 1].T @ h2
            h = h + h2
            hk1 = np.linalg.norm(w)
            Hm[: k + 1, k] = h
            Hm[k + 1, k] = hk1
            if hk1 > 0:
                V[k + 1] = w / hk1
            for j in range(k):
                t = cs_g[j] * Hm[j, k] + sn_g[j] * Hm[j + 1, k]
                Hm[j + 1, k] = -sn_g[j] * Hm[j, k] + cs_g[j] * Hm[j + 1, k]
                Hm[j, k] = t
            t = np.hypot(Hm[k, k], Hm[k + 1, k])
            if t > 0:
                cs_g[k], sn_g[k] = Hm[k, k] / t, Hm[k + 1, k] / t
            else:
                cs_g[k], sn_g[k] = 1.0, 0.0
            Hm[k, k] = cs_g[k] * Hm[k, k] + sn_g[k] * Hm[k + 1, k]
            Hm[k + 1, k] = 0.0
            eta[k + 1] = -sn_g[k] * eta[k]
            eta[k] = cs_g[k] * eta[k]
            k_used = k + 1
            if abs(eta[k + 1]) < tol * bnrm or hk1 == 0.0:
                break
        y = np.linalg.solve(
            Hm[:k_used, :k_used].astype(np.float64), eta[:k_used].astype(np.float64)
        ).astype(F32)
        x = x + V[:k_used].T @ y
        r = b - matvec(x)
        nmv += 1
        hist.append(float(np.linalg.norm(r)))
    return x, np.asarray(hist), nmv
