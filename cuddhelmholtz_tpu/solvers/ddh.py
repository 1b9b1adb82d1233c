"""DDH: substructured domain-decomposition WaveHoltz preconditioner.

Capability parity with the reference ``DDH`` (``/root/reference/source/DDH.cpp``,
``include/DDH.hpp``): an approximate Helmholtz inverse built from
non-overlapping subdomains.  Each application runs ``wh_maxit`` fixed-point
WaveHoltz iterations of a staggered-leapfrog wave-equation integrator on every
subdomain independently, with impedance (damping) coupling on subdomain faces
and transmission variables lambda/mu exchanged between face-DOF duals
(``cmap``).  GMRES solves the substructured fixed-point system
``(I - S) lambda = b`` whose unknowns live only on subdomain interfaces.

Design (vs. the reference's one CUDA block per subdomain with an inline
sum-factorised stiffness in shared memory, ``DDH.cpp:111-321``):

  * the <=(pad) x (pad) subdomain stiffness is **assembled dense once** at
    setup; the time loop then needs zero gathers -- each step is one batched
    (n_domains, pad) @ (pad, pad) matmul plus elementwise updates.  When all
    subdomains share identical geometry (uniform meshes) a single shared
    matrix is detected and used.
  * subdomain state lives in a (n_domains, pad) array; the whole
    5 x nt x 2-stage cycle is one XLA ``lax.scan`` (``_wave_cycle_xla``).
  * ``DDH.prepare`` turns the (linear) cycle into per-subdomain transfer
    matrices and io maps, so a solve runs no wave cycle at all: each GMRES
    matvec is one batched (ndom, 2pf) @ (2pf, 2pf) matmul.
  * forcing gather (x -> subdomains), lambda exchange (B tables from
    ``cmap``), and mass-weighted scatter back happen once per apply.

All state is fp32, like the reference, and every matmul of the cycle runs at
``PRECISION`` (true fp32, docs/DTYPES.md).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.mass import lumped_mass_diagonal
from ..spaces.ensemble import EnsembleSpace, structured_labels
from ..spaces.h1 import H1Space

WH_MAXIT = 5  # fixed-point WaveHoltz iterations per apply (DDH.cpp:136)

# Bump whenever the transfer/io precompute ALGEBRA or stored layout changes:
# the disk cache key folds this in so stale maps are never reloaded under a
# new algorithm (the problem-content part of the key cannot see code changes).
# v4: probes run at true fp32 ("highest") on every backend and the dedup key
# is computed from host data; entries probed under older numerics must not
# be reloaded.
_CACHE_FORMAT_VERSION = 4

# Matmul precision of the wave-cycle stiffness apply and of every probe that
# builds the transfer matrices and io maps.  The reference runs this cycle in
# true fp32 (SURVEY.md section 1).  On the GPU "default" and "high" let XLA
# use TF32 tensor cores (10-bit mantissa), whose rounding accumulates over
# the 5 x nt x 2 step cycle; "highest" is true fp32 (docs/DTYPES.md gives
# the measured error of each word on the card).
PRECISION = "highest"


class DDHParams(NamedTuple):
    """Device data for the batched DDH apply.

    Subdomain state arrays are (ndom, pad).  The trace (lambda) exchange runs
    on COMPACT (ndom, pf) arrays, pf = max face DOFs per subdomain: gathers
    and scatters cost about linearly in indexed elements, so indexing 4x
    fewer face slots than the full pad slots moves 4x fewer elements.
    """

    S: jax.Array  # (pad, pad) shared or (ndom, pad, pad) per-domain stiffness
    gI: jax.Array  # int32, -1 padded: subdomain slot -> global DOF
    gmask: jax.Array  # float, 1.0 where slot is a real DOF
    F_weight: jax.Array  # forcing gather weight (1, or m_p/m for "mass" split)
    Ha: jax.Array  # (ndom, pad) a * H (impedance damping)
    inv_mi: jax.Array  # 1 / (a^2 m) on valid slots, 0 on padding
    m_gmi: jax.Array  # m * (global lumped mass)^-1 partition-of-unity weight
    fslot: jax.Array  # (ndom, pf) int32: face-space dof -> pad slot (-1 pad)
    Hf: jax.Array  # (ndom, pf) face mass at face slots (0 on padding)
    a2wf: jax.Array  # (ndom, pf) 2 a omega at face slots
    B0: jax.Array  # (ndom, pf) int32: own lambda id == d*pf + k (-1 none/lost)
    B1: jax.Array  # (ndom, pf) int32: dual lambda id, own-slot layout (-1 none)
    tables: jax.Array  # (nt, 5): cs_half0, sn_half0, cs_half1, sn_half1, K_t
    K0: jax.Array  # scalar: half-weighted filter at t=0
    dt: jax.Array
    omega: jax.Array


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _row_ids(A: np.ndarray) -> np.ndarray:
    """Integer id per leading-axis entry; entries with equal bytes share one."""
    import hashlib

    seen: dict = {}
    return np.asarray(
        [
            seen.setdefault(hashlib.sha1(np.ascontiguousarray(a).tobytes()).digest(), len(seen))
            for a in A
        ],
        dtype=np.int64,
    )


def _assemble_subdomain_stiffness(
    space: H1Space, efem: EnsembleSpace, local_dofs_perm: np.ndarray, pad: int
) -> tuple[np.ndarray, bool]:
    """Dense assembled subdomain stiffness from GLL-collocated factors.

    Uses the same collocation as the reference DDH (GLL basis nodes, weights
    w_i w_j; ``DDH.cpp:15-58``), assembled into a dense symmetric matrix per
    subdomain instead of applied matrix-free per time step.

    Returns ``(S, shared)``: ``S`` is one ``(pad, pad)`` matrix with
    ``shared=True`` when every subdomain provably assembles the same matrix
    (identical local numbering and element geometry, e.g. uniform meshes),
    else the full ``(ndom, pad, pad)`` stack assembled by one vectorised
    scatter-add (no Python loop over subdomains).
    """
    nb = space.n_basis
    nb2 = nb * nb
    quad = space.basis.quadrature
    metrics = space.mesh.element_metrics(quad)
    J = metrics.jacobians  # (nel, ix, iy, a, b)
    x_xi, x_eta = J[..., 0, 0], J[..., 0, 1]
    y_xi, y_eta = J[..., 1, 0], J[..., 1, 1]
    detj = x_xi * y_eta - x_eta * y_xi
    w2 = np.outer(quad.w, quad.w)  # (ix, iy)
    A = (w2 * (y_eta**2 + x_eta**2) / detj).transpose(0, 2, 1)  # (nel, iy, ix)
    B = (-w2 * (y_xi * y_eta + x_xi * x_eta) / detj).transpose(0, 2, 1)
    C = (w2 * (y_xi**2 + x_xi**2) / detj).transpose(0, 2, 1)
    nel = space.mesh.n_elem
    # per-element factors flattened: the element stiffness is LINEAR in these
    G = np.concatenate(
        [A.reshape(nel, nb2), B.reshape(nel, nb2), C.reshape(nel, nb2)], axis=1
    )  # (nel, 3 nb2)

    Kb = _stiffness_factor_basis(space.basis.derivative_matrix)  # (3 nb2, nb2*nb2)

    ndom = efem.n_domains
    n_elems = efem.n_elems[:ndom]
    mx = local_dofs_perm.shape[1]
    idx = local_dofs_perm.reshape(ndom, mx, nb2)

    ne0 = int(n_elems[0])
    same_shape = bool(np.all(n_elems == ne0)) and bool(
        np.all(idx[:, :ne0] == idx[0, :ne0])
    )
    if same_shape:
        gels = efem.elems[:, :ne0]  # (ndom, ne0)
        # identical geometric factors => identical element stiffness (linear)
        shared = bool(
            np.abs(G[gels] - G[gels[0]][None]).max()
            <= 1e-12 * max(np.abs(G).max(), 1.0)
        )
        if shared:
            S_el0 = (G[gels[0]] @ Kb).reshape(ne0, nb2, nb2)
            S0 = np.zeros((pad, pad))
            for el in range(ne0):
                ix = idx[0, el]
                S0[np.ix_(ix, ix)] += S_el0[el]
            return S0, True

    # general case: one matmul for all element matrices, then one flat
    # scatter-add over all (domain, element) pairs
    S_el = (G @ Kb).reshape(nel, nb2, nb2)
    valid = np.arange(mx)[None, :] < n_elems[:, None]  # (ndom, mx)
    gels = np.where(valid, efem.elems[:, :mx], 0)
    vals = S_el[gels] * valid[:, :, None, None]  # (ndom, mx, nb2, nb2)
    ix = np.where(valid[:, :, None], idx, 0)
    rows = ix[:, :, :, None]
    cols = ix[:, :, None, :]
    dom = np.arange(ndom)[:, None, None, None]
    flat = (dom * pad + rows) * pad + cols
    S = np.zeros(ndom * pad * pad)
    np.add.at(S, flat.reshape(-1), vals.reshape(-1))
    return S.reshape(ndom, pad, pad), False


def _stiffness_factor_basis(D: np.ndarray) -> np.ndarray:
    """(3 nb2, nb2*nb2) matrix mapping collocated factors (A, B, C) to the
    flattened element stiffness: ``S_el = [A B C].flat @ Kb``.

    Built by pushing one-hot factor grids through the collocated operator
    applied to the nodal identity (the quadrature IS the GLL node grid, so
    interpolation is the identity and differentiation is D).
    """
    nb = D.shape[0]
    nb2 = nb * nb
    eye = np.eye(nb2).reshape(nb2, nb, nb)
    E = eye  # basis inputs U_b[b, l, k]
    Ux = np.einsum("qk,blk->blq", D, E)  # du/dxi  at (l, qx)
    Uy = np.einsum("ql,blk->bqk", D, E)  # du/deta at (qy, k)
    Z = np.zeros((nb2, nb, nb))
    Af = np.concatenate([eye, Z, Z])  # one-hot factor grids (3 nb2, nb, nb)
    Bf = np.concatenate([Z, eye, Z])
    Cf = np.concatenate([Z, Z, eye])
    fx = Af[:, None] * Ux[None] + Bf[:, None] * Uy[None]  # (3 nb2, b, l, q)
    fy = Bf[:, None] * Ux[None] + Cf[:, None] * Uy[None]
    out = np.einsum("qk,gblq->gblk", D, fx) + np.einsum("ql,gbqk->gblk", D, fy)
    # rows = (l, k) test index, columns = b trial index (as in the reference
    # collocated apply, DDH.cpp:60-109)
    return out.reshape(3 * nb2, nb2, nb2).transpose(0, 2, 1).reshape(3 * nb2, -1)


class DDH:
    """Set up the substructured DDH operator for an H1 space.

    For structured meshes pass nx, ny (reference behaviour: square subdomains
    of ``block_size`` DOFs per side, ``DDH.cpp:5,333-356``); otherwise pass
    explicit ``element_labels``.
    """

    def __init__(
        self,
        omega: float,
        a_nodal: np.ndarray,
        space: H1Space,
        nx: int | None = None,
        ny: int | None = None,
        element_labels: np.ndarray | None = None,
        n_domains: int | None = None,
        block_size: int = 16,
        dtype=jnp.float32,
        nt_override: int | None = None,
        pad_multiple: int = 128,
        wh_maxit: int = WH_MAXIT,
        rhs_split: str = "full",
    ):
        nb = space.n_basis
        mesh = space.mesh

        if element_labels is None:
            if nx is None or ny is None:
                raise ValueError("need nx, ny (structured) or element_labels")
            epd = block_size // nb
            if epd < 1 or block_size % nb:
                raise ValueError("block_size must be a multiple of n_basis")
            element_labels, n_domains = structured_labels(nx, ny, epd, epd)
        elif n_domains is None:
            n_domains = int(np.max(element_labels)) + 1

        efem = EnsembleSpace(space, n_domains, element_labels)
        self.efem = efem
        self.space = space
        self.omega = float(omega)
        self.g_ndof = space.ndof
        self.n_domains = n_domains
        # set below: own-slot layout sizes (n_lambda = n_own + n_lost)
        self.dtype = dtype
        self.wh_maxit = int(wh_maxit)
        self.precision = PRECISION
        if rhs_split not in ("full", "mass"):
            raise ValueError("rhs_split must be 'full' or 'mass'")
        self.rhs_split = rhs_split

        # --- WaveHoltz time grid and filter (DDH.cpp:360-386) ---------------
        T = 2 * np.pi / omega
        h = mesh.min_h()
        dt = 0.2 * 0.5 * h / (nb * nb)
        nt = int(np.ceil(T / dt)) if nt_override is None else int(nt_override)
        dt = T / nt
        self.nt = nt
        self.dt = dt
        k = np.arange(nt + 1)
        filt = dt * (omega / np.pi) * (np.cos(omega * k * dt) - 0.25)
        filt[0] *= 0.5
        filt[nt] *= 0.5
        th = 0.5 * np.arange(2 * nt + 1) * dt
        cs = -np.cos(omega * th)
        sn = np.sin(omega * th)
        it = np.arange(1, nt + 1)
        tables = np.stack(
            [cs[2 * it - 2], sn[2 * it - 2], cs[2 * it - 1], sn[2 * it - 1], filt[it]],
            axis=1,
        )

        # --- lambda numbering: dual-trace B tables from cmap (DDH.cpp:408-440)
        # The reference fills B row-by-row over cmap (side 0 then side 1 of
        # row k, k ascending); at corner slots touched by several rows the
        # LAST row in that interleaved order wins (DDH.cpp:429-440).  A naive
        # vectorisation (all side-0 writes, then all side-1 writes) resolves
        # corners in favour of the side-1 row instead — a different
        # transmission pairing at every cross point, caught by the
        # reference-oracle test.  Reproduce the exact write order: stamp each
        # write with its global sequence number and keep the max per slot.
        n_shared = efem.n_shared_dofs
        mx_fdof = efem.mx_fdof
        B = np.full((n_domains, mx_fdof, 2), -1, dtype=np.int32)
        cm = efem.cmap
        if n_shared > 0:
            k = np.arange(n_shared, dtype=np.int64)
            slots = np.empty(2 * n_shared, dtype=np.int64)  # write order
            slots[0::2] = cm[:, 0].astype(np.int64) * mx_fdof + cm[:, 2]
            slots[1::2] = cm[:, 1].astype(np.int64) * mx_fdof + cm[:, 3]
            order = np.arange(2 * n_shared, dtype=np.int64)
            last = np.full(n_domains * mx_fdof, -1, dtype=np.int64)
            np.maximum.at(last, slots, order)
            win = last[slots] == order  # this write is the slot's final one
            val0 = np.empty(2 * n_shared, dtype=np.int64)  # B(.,0): own trace
            val0[0::2] = k
            val0[1::2] = n_shared + k
            val1 = np.empty(2 * n_shared, dtype=np.int64)  # B(.,1): dual trace
            val1[0::2] = n_shared + k
            val1[1::2] = k
            B.reshape(-1, 2)[slots[win], 0] = val0[win]
            B.reshape(-1, 2)[slots[win], 1] = val1[win]

        # --- own-slot lambda layout --------------------------------------
        # Renumber the 2*n_shared trace unknowns so that a surviving lambda's
        # id IS its compact face-slot position (d*pf + k): reading the own
        # traces is then a plain reshape of the lambda vector instead of a
        # ~n_lambda-element gather on every matvec.  Ids overwritten in B0 at
        # subdomain-corner slots (the reference's last-write-wins B-table
        # semantics, DDH.cpp:408-440) are appended as a tail: they are
        # written by duals but never read, exactly as in the original
        # numbering.  Invalid slots become decoupled always-zero coordinates
        # (zero rhs, identity action), so GMRES trajectories are preserved
        # up to fp reduction order.
        own = B[:, :, 0].reshape(-1)
        validslot = own >= 0
        n_own = n_domains * mx_fdof
        newid = np.full(2 * n_shared, -1, dtype=np.int64)
        newid[own[validslot]] = np.nonzero(validslot)[0]
        lost = np.nonzero(newid < 0)[0]
        newid[lost] = n_own + np.arange(lost.size)
        self.n_own = n_own
        self.n_lost = int(lost.size)
        self.n_lambda = n_own + self.n_lost
        # reference-numbering id -> own-slot id (index k of the cmap row for
        # lambda0, n_shared + k for lambda1); used by the reference-oracle
        # tests to map trace vectors between the two layouts
        self.lambda_newid = newid.copy()
        if n_shared > 0:
            B = np.where(B >= 0, newid[np.maximum(B, 0)], -1).astype(np.int32)

        # --- DOF layout ------------------------------------------------------
        # The reference permutes each subdomain's DOFs face-first so face data
        # can live in the leading thread indices (DDH.cpp:442-481).  Here face
        # quantities (H, B tables) are instead embedded at their natural
        # subspace slots via pI, which keeps the local numbering canonical:
        # identical subdomains then assemble *identical* stiffness matrices and
        # the batched matmul can share one (pad, pad) matrix.
        mx_dof = efem.mx_ndof
        pad = _pad_to(mx_dof, pad_multiple)
        self.pad = pad
        gI = np.full((n_domains, pad), -1, dtype=np.int32)
        gI[:, :mx_dof] = efem.gI
        local_dofs_perm = efem.local_dofs

        # --- subdomain operators (fp32 collocated data, DDH.cpp:512-608) ----
        quad = space.basis.quadrature
        metrics = mesh.element_metrics(quad)
        detj = metrics.measures.transpose(0, 2, 1)  # (nel, iy, ix)
        w2 = np.outer(quad.w, quad.w)

        # lumped subdomain mass: one flat scatter-add over every (domain,
        # element) pair (padded elements contribute masked zeros at slot 0)
        emask = efem.elems >= 0  # (nd, mx_e)
        gels = np.maximum(efem.elems, 0)
        mvals = (w2[None, None] * detj[gels]) * emask[:, :, None, None]
        mslots = np.maximum(local_dofs_perm, 0)  # (nd, mx_e, nb, nb)
        mflat = (
            np.arange(n_domains, dtype=np.int64)[:, None, None, None] * pad + mslots
        )
        m_sub = np.zeros(n_domains * pad)
        np.add.at(m_sub, mflat.reshape(-1), mvals.reshape(-1))
        m_sub = m_sub.reshape(n_domains, pad)

        gmi = 1.0 / lumped_mass_diagonal(space)
        a_nodal = np.asarray(a_nodal, dtype=np.float64)
        valid = gI >= 0
        a_sub = np.where(valid, a_nodal[np.maximum(gI, 0)], 0.0)
        gmi_sub = np.where(valid, gmi[np.maximum(gI, 0)], 0.0)

        # face damping H: same flat scatter-add over (domain, face, node)
        H_sub = np.zeros(n_domains * pad)
        edge_meas = 0.5 * mesh.edge_lengths()
        if efem.mx_faces > 0:
            es = np.maximum(efem.faces, 0)  # (nd, mx_f)
            fvals = edge_meas[es][:, :, None] * quad.w[None, None, :]
            ok = efem.fI >= 0  # padded faces/nodes carry -1
            fvals = np.where(ok, fvals, 0.0).reshape(n_domains, -1)
            fidx = np.maximum(efem.fI, 0).reshape(n_domains, -1)
            fslots = np.take_along_axis(efem.pI, fidx, axis=1)
            fslots = np.where(
                ok.reshape(n_domains, -1), np.maximum(fslots, 0), 0
            )
            fflat = np.arange(n_domains, dtype=np.int64)[:, None] * pad + fslots
            np.add.at(H_sub, fflat.reshape(-1), fvals.reshape(-1))
        H_sub = H_sub.reshape(n_domains, pad)

        with np.errstate(divide="ignore"):
            inv_mi = np.where(valid, 1.0 / (a_sub**2 * np.where(valid, m_sub, 1.0)), 0.0)

        S, shared = _assemble_subdomain_stiffness(space, efem, local_dofs_perm, pad)
        if shared or n_domains == 1:
            # identical subdomains (uniform meshes): one (pad, pad) matrix
            # feeds every batch row of the wave cycle
            self.shared_S = True
            S_dev = S if S.ndim == 2 else S[0]
        else:
            # the structural check missed; fall back to numeric detection via
            # two random matvec probes (O(ndom pad^2) instead of a full
            # (ndom, pad, pad) broadcast compare).  The compute path is fp32,
            # so agreement below fp32 resolution counts as identical.
            scale = np.abs(S[0]).max() or 1.0
            rng = np.random.default_rng(0)
            probes = rng.standard_normal((pad, 2))
            sp = S @ probes  # (ndom, pad, 2)
            self.shared_S = bool(
                np.abs(sp - sp[0]).max() < 1e-6 * scale * np.abs(probes).max() * pad
            )
            S_dev = S[0] if self.shared_S else S
        # dedup key of each domain's stiffness, from the host copy: domains
        # whose fp32 matrices are bitwise equal share one id (see
        # ``_domain_groups``).  A key taken from device matmul probes would
        # depend on how the backend's batched matmul splits the batch.
        self._S_ids = (
            np.zeros(n_domains, np.int64)
            if self.shared_S
            else _row_ids(np.asarray(S_dev, dtype=np.dtype(jnp.dtype(dtype))))
        )

        # compact trace-exchange tables over face-space DOFs (pf = mx_fdof):
        # fslot embeds face dof j at its subspace slot pI[p, j] (pI already
        # carries -1 padding beyond each domain's fdof)
        fslot = efem.pI[:, :mx_fdof].astype(np.int32, copy=True)
        fs_safe = np.maximum(fslot, 0)
        Hf = np.where(fslot >= 0, np.take_along_axis(H_sub, fs_safe, axis=1), 0.0)
        a2wf = np.where(
            fslot >= 0,
            2.0 * omega * np.take_along_axis(a_sub, fs_safe, axis=1),
            0.0,
        )
        # host copies kept for the transfer-operator precompute and the
        # dedup key (setup reads them without a device round-trip)
        self._fslot_np = fslot
        self._Hf_np = Hf
        self._B1_np = B[:, :, 1].copy() if n_shared > 0 else np.full(
            (n_domains, mx_fdof), -1, np.int32
        )
        self._B0_np = B[:, :, 0].copy() if n_shared > 0 else np.full(
            (n_domains, mx_fdof), -1, np.int32
        )
        self._gI_np = gI
        self._Ha_np = np.ascontiguousarray(H_sub * a_sub, dtype=np.float64)
        self._mi_np = np.ascontiguousarray(inv_mi, dtype=np.float64)
        self._a2wf_np = np.ascontiguousarray(a2wf, dtype=np.float64)
        # transfer operator storage: deduped host form (_T_u + groups);
        # the full per-domain device stack is materialized LAZILY through
        # the ``T`` property -- the rolled exchange never reads it, and at
        # nx=512/block-16 the (16384, 192, 192) fp32 stack is 2.4 GB
        self._T_u: np.ndarray | None = None
        self._T_dev: jax.Array | None = None
        self.use_transfer = False
        self.route: RollRoute | None = None
        self.route_offs: tuple = ()
        self.route_perms: tuple = ()
        self.io: IOMaps | None = None
        self._patch: tuple | None = None  # lazy (PatchIO, pshape) | (None, None)
        self.coarse_space = None  # two-level correction (solvers/coarse.py)
        self._coarse_meta: tuple | None = None
        self._cache_dir: str | None = None
        self.transfer_stats: dict = {}
        self.io_stats: dict = {}

        # Forcing split across subdomains.  The reference feeds the FULL
        # global rhs row to every subdomain that touches it (DDH.cpp:209-212),
        # which double-counts interface loads; "mass" splits by the
        # partition-of-unity weight m_p/m so interface rows sum exactly.
        if rhs_split == "mass":
            F_weight = m_sub * gmi_sub
        else:
            F_weight = np.where(valid, 1.0, 0.0)

        # CUDDH_DEBUG-mode audit of the apply-path index tables: device ops
        # mask out-of-range entries (mode="drop"), so a corrupted table would
        # otherwise produce wrong numbers silently (DDH.cpp:162-164 analog)
        from ..utils.debug import check_index_table

        check_index_table("DDH.gI", gI, self.g_ndof)
        check_index_table("DDH.fslot", fslot, pad)
        check_index_table("DDH.B0", B[:, :, 0], self.n_lambda)
        check_index_table("DDH.B1", B[:, :, 1], self.n_lambda)

        # content hash for the precompute disk cache, computed HERE from the
        # host staging arrays (hashing the device params later would copy
        # them back from the device)
        self._setup_key = self._compute_setup_key(
            S_dev, H_sub * a_sub, inv_mi, Hf, fslot, a2wf, tables, B
        )

        self.params = DDHParams(
            S=jnp.asarray(S_dev, dtype=dtype),
            gI=jnp.asarray(gI),
            gmask=jnp.asarray(valid, dtype=dtype),
            F_weight=jnp.asarray(F_weight, dtype=dtype),
            Ha=jnp.asarray(H_sub * a_sub, dtype=dtype),
            inv_mi=jnp.asarray(inv_mi, dtype=dtype),
            m_gmi=jnp.asarray(m_sub * gmi_sub, dtype=dtype),
            fslot=jnp.asarray(fslot),
            Hf=jnp.asarray(Hf, dtype=dtype),
            a2wf=jnp.asarray(a2wf, dtype=dtype),
            B0=jnp.asarray(B[:, :, 0]),
            B1=jnp.asarray(B[:, :, 1]),
            tables=jnp.asarray(tables, dtype=dtype),
            K0=jnp.asarray(filt[0], dtype=dtype),
            dt=jnp.asarray(dt, dtype=dtype),
            omega=jnp.asarray(omega, dtype=dtype),
        )

    # ------------------------------------------------------------- operators

    @property
    def size(self) -> int:
        """DOFs of the substructured problem: (lambda, mu) pairs."""
        return 2 * self.n_lambda

    @property
    def T(self) -> jax.Array | None:
        """Full per-domain trace-transfer stack (ndom, 2pf, 2pf), expanded
        from the deduped form on first access (the rolled exchange and the
        io-map paths never need it)."""
        if self._T_dev is None and self._T_u is not None:
            self._T_dev = jnp.asarray(self._T_u[self._T_groups])
        return self._T_dev

    @T.setter
    def T(self, value) -> None:
        self._T_dev = value

    def _debug_finite(self, name: str, x: jax.Array) -> None:
        """CUDDH_DEBUG finiteness check at the public API boundary (skipped
        for traced values inside jit, where no host check is possible)."""
        from ..utils.debug import check_finite, debug_enabled

        if debug_enabled() and not isinstance(x, jax.core.Tracer):
            check_finite(name, x)

    def action(self, lam: jax.Array) -> jax.Array:
        """y = lambda - S(lambda): the GMRES operator (DDH.cpp:611-639)."""
        self._debug_finite("DDH.action input", lam)
        if self.use_transfer and self.route is not None:
            return ddh_action_transfer_rolled(
                self.params,
                self.route,
                lam,
                self.n_own,
                self.route_offs,
                self.route_perms,
            )
        if self.use_transfer and (self._T_dev is not None or self._T_u is not None):
            return ddh_action_transfer(self.params, self.T, lam, self.n_own)
        return ddh_action(
            self.params,
            lam,
            n_own=self.n_own,
            wh_maxit=self.wh_maxit,
            precision=self.precision,
        )

    def _domain_groups(self):
        """Identical-subdomain dedup: (unique indices, group of each domain,
        unique count).  Domains with bitwise-identical cycle data (S, Ha,
        inv_mi, Hf, fslot, a2wf) have identical probe responses.  The key is
        built from host arrays only, so the grouping is the same on every
        backend.  Memoized: transfer AND io precompute both need it."""
        if getattr(self, "_domain_groups_cache", None) is not None:
            return self._domain_groups_cache
        fslot, Hf = self._fslot_np, self._Hf_np
        # the dedup key lives in the COMPUTE dtype: fp64 host geometry
        # differs by ulps across identical domains (different coordinate
        # arithmetic), which fp32 rounding collapses
        fdt = np.dtype(jnp.dtype(self.dtype))
        parts = [
            self._Ha_np.astype(fdt),
            self._mi_np.astype(fdt),
            self._a2wf_np.astype(fdt),
            Hf,
            fslot.astype(np.float64),
        ]
        if not self.shared_S:
            parts.append(self._S_ids[:, None].astype(np.float64))
        key = np.concatenate(
            [np.ascontiguousarray(x, dtype=np.float64) for x in parts], axis=1
        )
        _, uidx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
        self._domain_groups_cache = (uidx, inv.reshape(-1), len(uidx))
        return self._domain_groups_cache

    # ------------------------------------------------------- precompute cache

    def setup_cache_key(self) -> str:
        """Content hash identifying the precomputed transfer/io maps.

        T and the IOMaps are pure functions of the per-subdomain cycle data
        (S, Ha, inv_mi, Hf, fslot, a2wf, time tables) and the cycle
        parameters, so they can be persisted to disk and reloaded for any
        DDH with the same hash -- the analog of the reference's memoized
        metric collections (Mesh2D.cpp:343-365), but across processes.
        Computed once at construction from the host staging arrays.
        """
        return self._setup_key

    def _compute_setup_key(self, S, Ha, inv_mi, Hf, fslot, a2wf, tables, B) -> str:
        import hashlib

        h = hashlib.sha256()
        fdt = np.dtype(jnp.dtype(self.dtype))
        S = np.asarray(S)
        if S.ndim == 3 and S.size > (1 << 24):
            # large per-domain stacks: hash two deterministic probe responses
            rng = np.random.default_rng(0)
            S = S @ rng.standard_normal((self.pad, 2))
        for arr in (S, Ha, inv_mi, Hf, a2wf, tables):
            h.update(np.ascontiguousarray(arr, dtype=fdt).tobytes())
        for arr in (fslot, B[:, :, 0], B[:, :, 1]):
            h.update(np.ascontiguousarray(arr, dtype=np.int32).tobytes())
        h.update(
            repr(
                (
                    _CACHE_FORMAT_VERSION,
                    # backend identity: probe runs on two backends agree
                    # only to fp32 rounding; do not cross-load
                    jax.default_backend(),
                    self.wh_maxit,
                    self.precision,
                    self.pad,
                    self.n_own,
                    self.n_lost,
                    self.nt,
                    float(self.omega),
                    float(self.dt),
                    str(jnp.dtype(self.dtype)),
                )
            ).encode()
        )
        return h.hexdigest()[:24]

    def save_precomputed(self, cache_dir: str) -> str:
        """Persist the deduped transfer/io maps keyed by ``setup_cache_key``."""
        import os

        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"ddh_{self.setup_cache_key()}.npz")
        data = {"groups": self._T_groups}
        if self._T_u is not None:
            data["T_u"] = self._T_u
        if self.io is not None:
            for name in ("Pu", "Pv", "R", "Pul", "Pvl"):
                data[name] = np.asarray(getattr(self.io, name))
        if self.coarse_space is not None:
            cs = self.coarse_space
            data["coarse_V"] = np.asarray(cs.V)
            data["coarse_sd"] = np.asarray(cs.sd)
            data["coarse_dscale"] = np.asarray(cs.dscale)
            data["coarse_meta"] = np.asarray(self._coarse_meta, dtype=np.float64)
            from .coarse import SparseCoarseSpace

            if isinstance(cs, SparseCoarseSpace):
                data["coarse_nbr"] = np.asarray(cs.nbr)
                data["coarse_Eb"] = np.asarray(cs.Eb)
                data["coarse_Pinv"] = np.asarray(cs.Pinv)
            else:
                data["coarse_Einv"] = np.asarray(cs.Einv)
        # pid-suffixed tmp name: two processes racing on the same config must
        # not interleave writes into one tmp file (os.replace stays atomic)
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **data)
        os.replace(tmp, path)
        return path

    def try_load_precomputed(self, cache_dir: str) -> bool:
        """Load cached transfer/io maps if present; returns True on a hit.

        Restores ``T`` (and the roll route) and, when cached, the io maps --
        repeat runs then skip every probe cycle AND their compiles.
        """
        import os

        path = os.path.join(cache_dir, f"ddh_{self.setup_cache_key()}.npz")
        if not os.path.exists(path):
            return False
        try:
            with np.load(path) as z:
                inv = z["groups"]
                if "T_u" not in z.files:
                    return False
                T_u = z["T_u"]
                io_arrs = (
                    {name: z[name] for name in ("Pu", "Pv", "R", "Pul", "Pvl")}
                    if "Pu" in z.files
                    else None
                )
                coarse_arrs = (
                    {
                        k[len("coarse_") :]: z[k]
                        for k in z.files
                        if k.startswith("coarse_")
                    }
                    if "coarse_V" in z.files
                    else None
                )
        except Exception:
            # truncated/corrupt cache entry (e.g. a crashed writer): treat as
            # a miss and drop the bad file so the next save replaces it
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self._T_groups = inv
        self._T_u = T_u
        self._T_dev = None
        self.use_transfer = True
        built = _build_roll_route(T_u, inv, self._B1_np, self.n_own)
        if built is not None:
            self.route, self.route_offs, self.route_perms = built
        if io_arrs is not None:
            nu = T_u.shape[0]
            group, maj, spec = _iomaps_split(inv)
            self.io = IOMaps(
                onehot=jnp.asarray(
                    (inv[None, :] == np.arange(nu)[:, None]).astype(np.float32)
                ),
                group=group,
                maj=maj,
                spec_idx=spec,
                **{k: jnp.asarray(v) for k, v in io_arrs.items()},
            )
        if coarse_arrs is not None and (
            "Eb" in coarse_arrs and coarse_arrs["Eb"].ndim != 3
        ):
            # entry written before the sparse Eb moved to its batched-matmul
            # layout: drop the coarse part (the transfer/io maps stay valid)
            coarse_arrs = None
        if coarse_arrs is not None:
            from .coarse import CoarseSpace, SparseCoarseSpace

            if "Eb" in coarse_arrs:
                self.coarse_space = SparseCoarseSpace(
                    V=jnp.asarray(coarse_arrs["V"]),
                    sd=jnp.asarray(coarse_arrs["sd"]),
                    dscale=jnp.asarray(coarse_arrs["dscale"]),
                    nbr=jnp.asarray(coarse_arrs["nbr"]),
                    Eb=jnp.asarray(coarse_arrs["Eb"]),
                    Pinv=jnp.asarray(coarse_arrs["Pinv"]),
                )
            else:
                self.coarse_space = CoarseSpace(
                    V=jnp.asarray(coarse_arrs["V"]),
                    sd=jnp.asarray(coarse_arrs["sd"]),
                    Einv=jnp.asarray(coarse_arrs["Einv"]),
                    dscale=jnp.asarray(coarse_arrs["dscale"]),
                )
            self._coarse_meta = tuple(coarse_arrs["meta"].tolist())
        return True

    def prepare(
        self,
        cache_dir: str | None = None,
        want_io: bool = True,
        chunk: int | None = None,
    ) -> dict:
        """Load-or-compute the transfer (and optionally io) maps.

        ``cache_dir=None`` resolves ``CUDDH_CACHE_DIR`` (default: the
        gitignored ``.ddh_cache/`` at the root of the checkout, a fixed path
        so that repeat runs from one checkout hit it); pass
        ``cache_dir=""`` to disable persistence.  Returns a stats dict
        (seconds per phase, cache state) that drivers/benchmarks surface,
        so setup cost is always recorded.
        """
        import os
        import time as _time

        if cache_dir is None:
            cache_dir = os.environ.get(
                "CUDDH_CACHE_DIR",
                os.path.join(
                    os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))),
                    ".ddh_cache",
                ),
            )
        self._cache_dir = cache_dir or None  # make_coarse persists here too
        stats: dict = {"cache_hit": False, "cache_dir": cache_dir or None}
        t0 = _time.perf_counter()
        if cache_dir and self.try_load_precomputed(cache_dir):
            stats["cache_hit"] = True
            stats["load_seconds"] = _time.perf_counter() - t0
            stats["transfer_nu"] = int(self._T_u.shape[0])
            if self.io is None and want_io:
                # older cache entry without io maps: compute + refresh it
                # (when the maps stay ineligible -- size gate -- there is
                # nothing new to persist, so skip the re-save)
                t1 = _time.perf_counter()
                io = self.precompute_io_maps(chunk=chunk)
                stats["io_seconds"] = _time.perf_counter() - t1
                stats.update(getattr(self, "io_stats", {}))
                if io is not None:
                    self.save_precomputed(cache_dir)
            return stats
        t1 = _time.perf_counter()
        T = self.precompute_transfer(chunk=chunk)
        T.block_until_ready()
        stats["transfer_seconds"] = _time.perf_counter() - t1
        stats.update(self.transfer_stats)
        if want_io:
            t1 = _time.perf_counter()
            io = self.precompute_io_maps(chunk=chunk)
            if io is not None:
                io.Pu.block_until_ready()
            stats["io_seconds"] = _time.perf_counter() - t1
            stats.update(getattr(self, "io_stats", {}))
        if cache_dir:
            self.save_precomputed(cache_dir)
        return stats

    def _probe_setup(self, ncols: int, chunk: int | None):
        """Shared inputs of the probe runs: the dedup groups, the unique
        domains' cycle data, and the column chunk size."""
        uidx, inv, nu = self._domain_groups()
        fdt = np.dtype(jnp.dtype(self.dtype))
        Ha_u = jnp.asarray(self._Ha_np[uidx].astype(fdt))
        mi_u = jnp.asarray(self._mi_np[uidx].astype(fdt))
        p = self.params
        S_u = p.S if p.S.ndim == 2 else p.S[jnp.asarray(uidx)]
        if chunk is None:
            # bound the fp32 state rows to ~128 MB (the deduped S stack
            # broadcasts over the probe columns, so it sets no cap)
            chunk = int(max(1, min(ncols, (1 << 25) // max(1, nu * self.pad))))
        return uidx, inv, nu, (Ha_u, mi_u, S_u), chunk

    def _run_probes(self, run, ncols: int, chunk: int, columns):
        """Run ``run(Fb, Gb)`` over probe-column chunks; ``columns(k0, c)``
        builds the (c, nu, pad) host forcing pair of columns k0..k0+c.
        Returns the per-chunk outputs and wall seconds: the first chunk
        includes the jit compile, the rest are pure probe execution."""
        import time as _time

        outs, secs = [], []
        for k0 in range(0, ncols, chunk):
            Fb, Gb = columns(k0, min(chunk, ncols - k0))
            t0 = _time.perf_counter()
            out = jax.block_until_ready(run(jnp.asarray(Fb), jnp.asarray(Gb)))
            secs.append(_time.perf_counter() - t0)
            outs.append(out)
        return outs, secs

    def precompute_transfer(self, chunk: int | None = None) -> jax.Array:
        """Precompute the dense per-subdomain trace-transfer (scattering) operator.

        The WaveHoltz cycle is LINEAR in the incoming traces: for each
        subdomain the map from its 2*pf compact trace inputs (lam0, mu0) to
        its transmission outputs (a*2w*v_f, a*2w*u_f) is a fixed
        (2pf, 2pf) matrix T_p.  Building T_p once -- 2*pf batched wave cycles,
        done here by feeding one-hot trace columns through the production
        cycle -- turns every subsequent GMRES matvec from
        ``wh_maxit*nt*2`` batched (ndom, pad) @ (pad, pad) matmuls into ONE
        batched (ndom, 2pf) @ (2pf, 2pf) matmul.  This is the subdomain
        scattering-matrix form of substructuring; it pays off whenever the
        solve needs more than ~2*pf matvecs (the flagship config needs ~360)
        or the preconditioner is reused across right-hand sides.

        The reference re-integrates the wave equation per apply inside one
        CUDA block per subdomain (DDH.cpp:111-321); here the cycle runs only
        in these setup probes.
        """
        fslot, Hf = self._fslot_np, self._Hf_np
        pf = fslot.shape[1]
        pad = self.pad
        ncols = 2 * pf

        # --- identical-subdomain dedup ------------------------------------
        # The cycle output for a one-hot trace column depends only on this
        # domain's (S, Ha, inv_mi, Hf, fslot, a2wf); domains with bitwise-
        # identical data produce identical transfer matrices (uniform meshes
        # with piecewise-constant coefficients have only a handful of
        # distinct domain types), so run the ~2pf wave-cycle columns for the
        # UNIQUE domains only.
        uidx, inv, nu, data, chunk = self._probe_setup(ncols, chunk)
        self._T_groups = inv
        fdt = np.dtype(jnp.dtype(self.dtype))

        # one-hot trace forcing columns: column k (< pf) puts Hf[d, k] at
        # fslot[d, k] in F (the lam side); column pf + k does the same in G
        # (the mu side).  Each column touches exactly one face DOF per
        # domain, so set == the production path's add even at corner slots.
        fslot_u, Hf_u = fslot[uidx], Hf[uidx]
        a2wf_u = jnp.asarray(self._a2wf_np[uidx].astype(fdt))
        fs_u = jnp.asarray(np.maximum(fslot_u, 0))
        kk, dd = np.meshgrid(np.arange(pf), np.arange(nu), indexing="ij")
        sl = np.maximum(fslot_u, 0)
        cols_F = np.zeros((pf, nu, pad), np.float32)
        cols_F[kk, dd, sl[dd, kk]] = Hf_u[dd, kk]
        wh_maxit, precision = self.wh_maxit, self.precision

        # the per-domain arrays are jit ARGUMENTS, not closure constants:
        # closed-over arrays are embedded in the program as literals (the
        # deduped S stack alone can be hundreds of MB at scale)
        @jax.jit
        def run_chunk(p, data, fs_u, a2wf_u, Fb, Gb):
            u, v = _probe_cycle(p, *data, Fb, Gb, wh_maxit, precision)
            idx = jnp.broadcast_to(fs_u[None], u.shape[:2] + (pf,))
            uf = jnp.take_along_axis(u, idx, axis=2)
            vf = jnp.take_along_axis(v, idx, axis=2)
            return jnp.concatenate([a2wf_u[None] * vf, a2wf_u[None] * uf], axis=2)

        def columns(k0, c):
            f_rows = np.zeros((c, nu, pad), np.float32)
            g_rows = np.zeros((c, nu, pad), np.float32)
            n_lam = max(0, min(c, pf - k0))
            f_rows[:n_lam] = cols_F[k0 : k0 + n_lam]
            lo = max(0, k0 - pf)
            g_rows[n_lam:] = cols_F[lo : lo + (c - n_lam)]
            return f_rows, g_rows

        outs, secs = self._run_probes(
            lambda Fb, Gb: run_chunk(self.params, data, fs_u, a2wf_u, Fb, Gb),
            ncols, chunk, columns,
        )
        self.transfer_stats = {
            "transfer_nu": int(nu),
            "transfer_ncols": int(ncols),
            "transfer_chunk_cols": int(chunk),
            "transfer_first_chunk_seconds": secs[0],
            "transfer_exec_seconds": float(sum(secs[1:])),
            "transfer_chunk_seconds": [round(t, 3) for t in secs],
        }
        T_u = jnp.concatenate(outs, axis=0)  # (2pf, nu, 2pf): [col, dom, row]
        T_u = jnp.transpose(T_u, (1, 2, 0)).astype(self.dtype)  # (nu, row, col)
        self._T_u = np.asarray(T_u)  # deduped host form; full stack is lazy
        self._T_dev = None
        self.use_transfer = True
        # roll-based exchange when the dual graph is (near-)regular
        built = _build_roll_route(self._T_u, inv, self._B1_np, self.n_own)
        if built is not None:
            self.route, self.route_offs, self.route_perms = built
        return T_u

    def precompute_io_maps(self, chunk: int | None = None, max_bytes: int = 1 << 30):
        """Precompute the rhs/postprocess linear maps (see ``IOMaps``).

        Probes the production cycle with one-hot forcing columns (2*pad) and
        one-hot trace columns (2*pf) for the UNIQUE subdomains; afterwards
        ``rhs`` and ``postprocess`` are batched matmuls -- no wave cycle
        executes anywhere in a solve once this and ``precompute_transfer``
        have run.  Returns None (and leaves the wave path in use) when the
        stored maps would exceed ``max_bytes`` (very heterogeneous
        partitions).
        """
        fslot, Hf = self._fslot_np, self._Hf_np
        pf = fslot.shape[1]
        pad = self.pad
        nu = self._domain_groups()[2]
        need = 4 * nu * (2 * pad * 2 * pad + 2 * pf * 2 * pad + 2 * pad * 2 * pf)
        if need > max_bytes:
            return None
        ncols = 2 * pad + 2 * pf
        uidx, inv, nu, data, chunk = self._probe_setup(ncols, chunk)

        fslot_u, Hf_u = fslot[uidx], Hf[uidx]
        fdt = np.dtype(jnp.dtype(self.dtype))
        a2wf_u = jnp.asarray(self._a2wf_np[uidx].astype(fdt))
        fs_u = jnp.asarray(np.maximum(fslot_u, 0))

        # probe columns: j < pad -> F one-hot e_j; j < 2pad -> G one-hot;
        # last 2pf -> trace columns through the Hf face embedding (the same
        # columns the transfer operator probes)
        cols = np.zeros((ncols, 2, nu, pad), np.float32)
        cols[np.arange(pad), 0, :, np.arange(pad)] = 1.0
        cols[pad + np.arange(pad), 1, :, np.arange(pad)] = 1.0
        kk, dd = np.meshgrid(np.arange(pf), np.arange(nu), indexing="ij")
        sl = np.maximum(fslot_u, 0)
        base = 2 * pad
        cols[base + kk, 0, dd, sl[dd, kk]] = Hf_u[dd, kk]
        cols[base + pf + kk, 1, dd, sl[dd, kk]] = Hf_u[dd, kk]
        wh_maxit, precision = self.wh_maxit, self.precision

        # big arrays as jit ARGUMENTS, not closure constants (see
        # precompute_transfer)
        @jax.jit
        def run_chunk(p, data, Fb, Gb):
            return _probe_cycle(p, *data, Fb, Gb, wh_maxit, precision)

        outs, secs = self._run_probes(
            lambda Fb, Gb: run_chunk(self.params, data, Fb, Gb),
            ncols, chunk,
            lambda k0, c: (cols[k0 : k0 + c, 0], cols[k0 : k0 + c, 1]),
        )
        self.io_stats = {
            "io_nu": int(nu),
            "io_ncols": int(ncols),
            "io_chunk_cols": int(chunk),
            "io_first_chunk_seconds": secs[0],
            "io_exec_seconds": float(sum(secs[1:])),
        }
        U = jnp.concatenate([u for u, _ in outs], axis=0)  # (ncols, nu, pad)
        V = jnp.concatenate([v for _, v in outs], axis=0)

        bshape = (base, nu, pf)
        Uf = jnp.take_along_axis(U[:base], jnp.broadcast_to(fs_u[None], bshape), axis=2)
        Vf = jnp.take_along_axis(V[:base], jnp.broadcast_to(fs_u[None], bshape), axis=2)
        R = jnp.concatenate([a2wf_u[None] * Vf, a2wf_u[None] * Uf], axis=2)
        dt = self.dtype
        group, maj, spec = _iomaps_split(inv)
        self.io = IOMaps(
            Pu=jnp.transpose(U[:base], (1, 2, 0)).astype(dt),
            Pv=jnp.transpose(V[:base], (1, 2, 0)).astype(dt),
            R=jnp.transpose(R, (1, 2, 0)).astype(dt),
            Pul=jnp.transpose(U[base : base + 2 * pf], (1, 2, 0)).astype(dt),
            Pvl=jnp.transpose(V[base : base + 2 * pf], (1, 2, 0)).astype(dt),
            onehot=jnp.asarray(
                (inv[None, :] == np.arange(nu)[:, None]).astype(np.float32)
            ),
            group=group,
            maj=maj,
            spec_idx=spec,
        )
        return self.io

    def patch_io(self):
        """Lazy (PatchIO, pshape) for the grid-native window fast path;
        (None, None) when the numbering is not window-regular (see
        ``_build_patch_io``).  Built once, from concrete arrays: a call
        under a jit trace before it is built (``DDH.solver`` passes the io
        maps as traced arguments) takes the plain io path."""
        if self._patch is None:
            if self.io is None or isinstance(self.params.gI, jax.core.Tracer):
                return (None, None)
            self._patch = _build_patch_io(self.space, self.params, self.io)
        return self._patch

    def rhs(self, f: jax.Array) -> jax.Array:
        """Substructured RHS from the Helmholtz forcing (DDH.cpp:641-667)."""
        self._debug_finite("DDH.rhs input", f)
        if self.use_transfer and self.io is not None:
            pio, pshape = self.patch_io()
            if pio is not None:
                return ddh_rhs_io_patch(
                    self.params, self.io, pio, f, self.g_ndof, self.n_lambda,
                    pshape,
                )
            return ddh_rhs_io(self.params, self.io, f, self.g_ndof, self.n_lambda)
        return ddh_rhs(
            self.params,
            f,
            self.g_ndof,
            self.n_lambda,
            wh_maxit=self.wh_maxit,
            precision=self.precision,
        )

    def postprocess(self, lam: jax.Array, f: jax.Array) -> jax.Array:
        """Recover the (u, v) solution (DDH.cpp:669-695)."""
        self._debug_finite("DDH.postprocess lambda", lam)
        if self.use_transfer and self.io is not None:
            pio, pshape = self.patch_io()
            if pio is not None:
                return ddh_postprocess_io_patch(
                    self.params, self.io, pio, lam, f, self.g_ndof,
                    self.n_own, pshape,
                )
            return ddh_postprocess_io(
                self.params, self.io, lam, f, self.g_ndof, self.n_own
            )
        return ddh_postprocess(
            self.params,
            lam,
            f,
            self.g_ndof,
            n_own=self.n_own,
            wh_maxit=self.wh_maxit,
            precision=self.precision,
        )

    def make_coarse(
        self,
        n_dir: int = 4,
        domains_per_super: int = 16,
        ridge: float = 1e-8,
        method: str = "direct",
        solve_m: int = 40,
        solve_maxit: int = 4,
        solve_tol: float = 1e-3,
        ortho: bool = True,
    ):
        """Build (and store) the two-level plane-wave coarse space.

        Requires the transfer operator (``prepare``/``precompute_transfer``).
        See ``solvers/coarse.py``; use via ``solver(..., coarse=...)`` or
        ``coarse_correct``.  Beyond the reference (strictly one-level,
        DDH.cpp:111-321).  ``method="direct"`` stores a dense inverse
        (nc-capped); ``method="iterative"`` stores the block-sparse form
        over the superdomain adjacency graph and solves it on device with
        block-Jacobi GMRES (``solve_*`` control that inner solve) --
        skeleton-resolution spaces (nc ~ 1e5) only fit this way.  The
        result is folded into the setup disk cache: a matching cached
        space loaded by ``prepare`` is returned directly, and a freshly
        built one is persisted when ``prepare`` used a cache dir.
        """
        from .coarse import build_coarse_space, build_coarse_space_sparse

        if method not in ("direct", "iterative"):
            raise ValueError("method must be 'direct' or 'iterative'")
        self.coarse_solve = (int(solve_m), int(solve_maxit), float(solve_tol))
        iterative = method == "iterative"
        meta = (
            float(n_dir),
            float(domains_per_super),
            float(ridge),
            float(iterative),
            float(ortho if iterative else 0.0),
        )
        prev = getattr(self, "_coarse_meta", None)
        # older caches stored 3-field (always-direct) or 4-field (pre-ortho)
        # metas; pad with the defaults those builds used
        if prev is not None and len(prev) < 5:
            prev = (*prev, *((0.0,) * (5 - len(prev))))
        if self.coarse_space is not None and prev == meta:
            return self.coarse_space
        if iterative:
            self.coarse_space = build_coarse_space_sparse(
                self,
                n_dir=n_dir,
                domains_per_super=domains_per_super,
                ridge=ridge,
                dtype=self.dtype,
                ortho=ortho,
            )
        else:
            self.coarse_space = build_coarse_space(
                self,
                n_dir=n_dir,
                domains_per_super=domains_per_super,
                ridge=ridge,
                dtype=self.dtype,
            )
        self._coarse_meta = meta
        if getattr(self, "_cache_dir", None):
            self.save_precomputed(self._cache_dir)
        return self.coarse_space

    def coarse_correct(self, v: jax.Array) -> jax.Array:
        """q = Z E^{-1} Z^T v: the coarse component of the correction."""
        from .coarse import coarse_apply

        sm, smx, stl = getattr(self, "coarse_solve", (40, 4, 1e-3))
        return coarse_apply(
            self.coarse_space, self.params, v, self.n_own,
            solve_m=sm, solve_maxit=smx, solve_tol=stl,
        )

    def solver(
        self,
        m: int,
        maxit: int,
        tol: float,
        gmres_fn=None,
        vmapped: bool = False,
        coarse: str | None = None,
        block: bool = False,
        gmres_opts: dict | None = None,
    ):
        """Whole-solve jit (rhs -> lambda-GMRES -> postprocess) with the DDH
        device state passed as jit ARGUMENTS.

        Closing a jit over the DDH device arrays embeds them as HLO
        constants, which at large configs makes programs of hundreds of MB
        that compile slowly.  Passing the state pytree as an argument keeps
        the program small and lets repeat solves reuse one executable.  ``vmapped=True`` returns a batched solver over a
        leading right-hand-side axis (state broadcast), each source with
        its own lock-step Krylov space; ``block=True`` instead solves all
        sources in ONE shared block-Krylov space (``solvers.gmres.
        block_gmres``) — K× richer restarts for one batched matvec per
        step, the multi-source production path.
        """
        from .gmres import gmres as _gmres

        gmres_fn = gmres_fn or _gmres
        gmres_opts = gmres_opts or {}
        # capture only what the traced action path reads: forcing the full T
        # through the property would materialize the (ndom, 2pf, 2pf) stack
        # the rolled/io paths never use
        T_cap = None
        if self.use_transfer and self.route is None and self._T_u is not None:
            T_cap = self.T
        if coarse and self.coarse_space is None:
            raise ValueError("coarse solver requested but make_coarse() not run")
        if coarse not in (None, "additive", "multiplicative"):
            raise ValueError("coarse must be None, 'additive', or 'multiplicative'")
        state = (self.params, T_cap, self.route, self.io, self.coarse_space)

        def run(b, st):
            # save/restore the RAW ``_T_dev`` slot: going through the ``T``
            # property here would expand + upload the full (ndom, 2pf, 2pf)
            # stack on the rolled/io paths that never need it (2.4 GB at
            # nx=512/block-16), defeating the T_cap guard above
            old = (self.params, self._T_dev, self.route, self.io)
            self.params, self._T_dev, self.route, self.io = st[:4]
            try:
                Y = self.rhs(b)
                if coarse:
                    from .coarse import coarse_apply
                    from .gmres import fgmres

                    cs = st[4]
                    sm, smx, stl = getattr(self, "coarse_solve", (40, 4, 1e-3))

                    def P(v):
                        q = coarse_apply(
                            cs, self.params, v, self.n_own,
                            solve_m=sm, solve_maxit=smx, solve_tol=stl,
                        )
                        if coarse == "multiplicative":
                            # q + (I - A q) residual sweep: one extra action
                            # per iteration, stronger correction
                            return q + v - self.action(q)
                        return v + q

                    out = fgmres(self.action, Y, P, m=m, maxit=maxit, tol=tol)
                else:
                    out = gmres_fn(
                        self.action, Y, m=m, maxit=maxit, tol=tol, **gmres_opts
                    )
                U = self.postprocess(out.x, b)
            finally:
                self.params, self._T_dev, self.route, self.io = old
            return out, U

        if block:
            if coarse:
                raise ValueError("block=True does not compose with coarse yet")
            from .gmres import block_gmres

            def run_block(bs, st):
                old = (self.params, self._T_dev, self.route, self.io)
                self.params, self._T_dev, self.route, self.io = st[:4]
                try:
                    Y = jax.vmap(self.rhs)(bs)
                    out = block_gmres(
                        jax.vmap(self.action), Y, m=m, maxit=maxit, tol=tol,
                        **gmres_opts,
                    )
                    U = jax.vmap(self.postprocess)(out.x, bs)
                finally:
                    self.params, self._T_dev, self.route, self.io = old
                return out, U

            runb = jax.jit(run_block)
            return lambda bs: runb(bs, state)
        if vmapped:
            runv = jax.jit(jax.vmap(run, in_axes=(0, None)))
            return lambda bs: runv(bs, state)
        runj = jax.jit(run)
        return lambda b: runj(b, state)


class IOMaps(NamedTuple):
    """Precomputed linear input/output maps for ``rhs`` and ``postprocess``.

    The WaveHoltz cycle is linear in its forcing (F, G) and incoming traces,
    so the two real wave cycles the reference runs per solve (rhs: forcing ->
    transmission traces, DDH.cpp:641-667; postprocess: (lambda, forcing) ->
    solution, DDH.cpp:669-695) collapse to batched matmuls against maps
    probed once per UNIQUE subdomain (same dedup as the trace-transfer
    operator).  Shapes: pad = padded subdomain size, pf = padded face count,
    nu = unique-domain count.
    """

    Pu: jax.Array  # (nu, pad, 2pad)  (F, G) -> u
    Pv: jax.Array  # (nu, pad, 2pad)  (F, G) -> v/omega
    R: jax.Array  # (nu, 2pf, 2pad)  (F, G) -> [a2wf*vf, a2wf*uf]
    Pul: jax.Array  # (nu, pad, 2pf)  (lam0, mu0) -> u
    Pvl: jax.Array  # (nu, pad, 2pf)  (lam0, mu0) -> v/omega
    onehot: jax.Array  # (nu, ndom) group membership
    # majority split (set when >= half the domains share one matrix): the
    # group apply becomes one shared matmul + a gathered correction for the
    # special domains -- memory O(nspec * out * in) instead of the one-hot
    # path's O(nu * ndom * out) intermediate (8.4 GB at nx=1024/block16)
    group: jax.Array | None = None  # (ndom,) int32 group of each domain
    maj: jax.Array | None = None  # () int32 majority group id
    spec_idx: jax.Array | None = None  # (nspec,) sorted special domains


class PatchIO(NamedTuple):
    """Window-ordered variants of the io maps for grid-native numberings.

    On a row-major grid DOF numbering every subdomain's global ids form one
    (h, h) window at stride (s, s), so the forcing gather and the solution
    scatter-add collapse to ONE ``lax.conv_general_dilated_patches`` call
    and its linear transpose instead of a dynamic gather/scatter (its speed
    on the GPU against a plain gather is not measured yet).  The io
    matrices are pre-permuted ONCE on the host so no
    slot permutation runs at apply time; ``_build_patch_io`` verifies the
    window model reproduces ``gI`` exactly and returns None otherwise
    (reference-numbered H1Space, unstructured partitions).
    """

    Rw: jax.Array  # (nu, 2pf, 2nwin)   input cols window-ordered
    # the four postprocess maps fused into ONE grouped matmul
    # [[Pu, Pul], [Pv, Pvl]] acting on z = [Fw; Gw; lam0; mu0]: one kernel
    # instead of four small group applies in the solve loop
    Mw: jax.Array  # (nu, 2nwin, 2nwin + 2pf)
    w_F: jax.Array  # (1, nwin, nby, nbx) forcing weights, window order
    m_w: jax.Array  # (1, nwin, nby, nbx) solution combine weights


def _build_patch_io(space, params, io: IOMaps):
    """Host-verified PatchIO + static shape, or (None, None).

    Succeeds exactly when (a) the space's DOF coordinates are row-major
    grid-ordered, (b) every subdomain's valid ``gI`` ids are one full
    (h, h) window with a slot order shared by ALL subdomains, and (c) the
    window bases tile the grid row-major at a uniform stride.  Everything
    is checked against ``gI`` itself, so a false positive is impossible.
    """
    gI = np.asarray(params.gI)
    ndom, pad = gI.shape
    coords = np.asarray(space.coords)
    if coords.shape[0] < 4:
        return None, None
    ys = coords[:, 1]
    changes = np.nonzero(ys != ys[0])[0]
    if changes.size == 0:
        return None, None
    W = int(changes[0])
    if W <= 1 or coords.shape[0] % W:
        return None, None
    H = coords.shape[0] // W
    valid = gI >= 0
    nv = valid.sum(axis=1)
    if not np.all(nv == nv[0]):
        return None, None
    nwin = int(nv[0])
    if not (np.all(valid[:, :nwin]) and not np.any(valid[:, nwin:])):
        return None, None
    core = gI[:, :nwin].astype(np.int64)
    base = core.min(axis=1)
    rel = core - base[:, None]
    if not np.all(rel == rel[0]):
        return None, None
    dr, dc = rel[0] // W, rel[0] % W
    h = int(dr.max()) + 1
    w = int(dc.max()) + 1
    if h != w or h * w != nwin:
        return None, None
    wpos = dr * w + dc  # slot -> window-row-major position
    if np.unique(wpos).size != nwin:
        return None, None
    br, bc = base // W, base % W
    ubr, ubc = np.unique(br), np.unique(bc)
    nby, nbx = ubr.size, ubc.size
    if nby * nbx != ndom:
        return None, None
    sr = int(ubr[1] - ubr[0]) if nby > 1 else h
    sc = int(ubc[1] - ubc[0]) if nbx > 1 else w
    if sr != sc or np.any(np.diff(ubr) != sr) or np.any(np.diff(ubc) != sc):
        return None, None
    if ubr[0] != 0 or ubc[0] != 0 or ubr[-1] + h != H or ubc[-1] + w != W:
        return None, None
    # identity domain order: d == by * nbx + bx
    if not (
        np.array_equal(br, np.repeat(ubr, nbx))
        and np.array_equal(bc, np.tile(ubc, nby))
    ):
        return None, None

    slot_of_w = np.empty(nwin, np.int64)
    slot_of_w[wpos] = np.arange(nwin)  # window position -> slot

    def in_cols(M):  # (..., 2pad) -> (..., 2nwin), [F;G] blocks
        M = np.asarray(M)
        return np.concatenate(
            [M[..., slot_of_w], M[..., pad + slot_of_w]], axis=-1
        )

    Pu, Pv = np.asarray(io.Pu), np.asarray(io.Pv)
    Pul, Pvl = np.asarray(io.Pul), np.asarray(io.Pvl)
    w_F = np.asarray(params.F_weight)[:, slot_of_w]  # (ndom, nwin)
    m_w = np.asarray(params.m_gmi)[:, slot_of_w]

    def dom_grid(A):  # (ndom, nwin) -> (1, nwin, nby, nbx)
        return jnp.asarray(
            A.reshape(nby, nbx, nwin).transpose(2, 0, 1)[None]
        )

    Mu = np.concatenate([in_cols(Pu[:, slot_of_w, :]), Pul[:, slot_of_w, :]], -1)
    Mv = np.concatenate([in_cols(Pv[:, slot_of_w, :]), Pvl[:, slot_of_w, :]], -1)
    pio = PatchIO(
        Rw=jnp.asarray(in_cols(io.R)),
        Mw=jnp.asarray(np.concatenate([Mu, Mv], axis=1)),
        w_F=dom_grid(w_F),
        m_w=dom_grid(m_w),
    )
    return pio, (H, W, h, sr)


def _patch_extract(x2, H: int, W: int, h: int, s: int):
    """(2, H*W) -> (2, h*h, nby, nbx) window-row-major patches."""
    img = x2.reshape(1, 2, H, W)
    pt = lax.conv_general_dilated_patches(img, (h, h), (s, s), "VALID")
    # features ordered (channel, window-row-major): (1, 2*h*h, nby, nbx)
    return pt.reshape(2, h * h, pt.shape[-2], pt.shape[-1])


def _patch_combine(uv_w, H: int, W: int, h: int, s: int):
    """Transpose of ``_patch_extract``: overlap-add back to (2, H*W).

    Implemented as a 4-way parity split (valid whenever h <= 2s, the only
    case ``_build_patch_io`` admits): blocks two apart never overlap, so
    each (by%2, bx%2) group is a DISJOINT tiling realisable with pure
    pad/transpose/reshape layout ops and one elementwise add per group --
    no scatter and no input-dilated conv (the ``linear_transpose`` conv of
    the extraction lowers to a dense 13x13x169-channel gradient conv)."""
    C = uv_w.shape[0]
    nby, nbx = uv_w.shape[-2:]
    S2 = 2 * s
    P5 = jnp.transpose(uv_w, (0, 2, 3, 1)).reshape(C, nby, nbx, h, h)
    Hp, Wp = H + 2 * S2, W + 2 * S2
    out = jnp.zeros((C, Hp, Wp), uv_w.dtype)
    for py in range(2):
        for px in range(2):
            blk = P5[:, py::2, px::2]  # (C, mby, mbx, h, h)
            mby, mbx = blk.shape[1], blk.shape[2]
            blk = jnp.pad(
                blk, ((0, 0), (0, 0), (0, 0), (0, S2 - h), (0, S2 - h))
            )
            tile = jnp.transpose(blk, (0, 1, 3, 2, 4)).reshape(
                C, mby * S2, mbx * S2
            )
            oy, ox = py * s, px * s
            tile = jnp.pad(
                tile,
                (
                    (0, 0),
                    (oy, Hp - oy - mby * S2),
                    (ox, Wp - ox - mbx * S2),
                ),
            )
            out = out + tile
    return out[:, :H, :W].reshape(C, H * W)


@partial(jax.jit, static_argnames=("g_ndof", "n_lambda", "pshape", "precision"))
def ddh_rhs_io_patch(
    params: DDHParams,
    io: IOMaps,
    pio: PatchIO,
    f: jax.Array,
    g_ndof: int,
    n_lambda: int,
    pshape: tuple,
    precision: str = "highest",
):
    """``ddh_rhs_io`` with the forcing gather as one patch-extraction conv."""
    H, W, h, s = pshape
    x2 = jnp.stack([f[:g_ndof], f[g_ndof:]]).astype(pio.w_F.dtype)
    FG = _patch_extract(x2, H, W, h, s) * pio.w_F  # (2, nwin, nby, nbx)
    nby, nbx = FG.shape[-2:]
    xin = jnp.transpose(FG, (2, 3, 0, 1)).reshape(nby * nbx, -1)
    w = _group_apply(
        pio.Rw, xin, io.onehot, io.group, io.maj, io.spec_idx, precision=precision
    )
    pf = params.Hf.shape[1]
    return _b1_scatter(params, -w[:, :pf], w[:, pf:], n_lambda, xin.dtype)


@partial(jax.jit, static_argnames=("g_ndof", "n_own", "pshape", "precision"))
def ddh_postprocess_io_patch(
    params: DDHParams,
    io: IOMaps,
    pio: PatchIO,
    lam: jax.Array,
    f: jax.Array,
    g_ndof: int,
    n_own: int,
    pshape: tuple,
    precision: str = "highest",
):
    """``ddh_postprocess_io`` with patch-conv forcing extraction and the
    mass-weighted global scatter as the patch transpose (overlap-add)."""
    H, W, h, s = pshape
    x2 = jnp.stack([f[:g_ndof], f[g_ndof:]]).astype(pio.w_F.dtype)
    FG = _patch_extract(x2, H, W, h, s) * pio.w_F
    nby, nbx = FG.shape[-2:]
    xin = jnp.transpose(FG, (2, 3, 0, 1)).reshape(nby * nbx, -1)
    n_lambda = lam.shape[0] // 2
    lam0, mu0 = _read_traces(params, lam, n_lambda, n_own)
    tr = jnp.concatenate([lam0, mu0], axis=1).astype(xin.dtype)
    z = jnp.concatenate([xin, tr], axis=1)
    uv = _group_apply(  # (ndom, 2nwin): [u_w | v_w]
        pio.Mw, z, io.onehot, io.group, io.maj, io.spec_idx, precision=precision
    )
    nwin = h * h
    uv = jnp.stack([uv[:, :nwin], uv[:, nwin:]]).reshape(2, nby, nbx, nwin)
    uv_w = jnp.transpose(uv, (0, 3, 1, 2)) * pio.m_w
    y2 = _patch_combine(uv_w, H, W, h, s)
    return y2.reshape(-1)


def _iomaps_split(inv: np.ndarray):
    """Majority-split metadata for ``_group_apply`` (None fields when no
    group covers at least half the domains)."""
    counts = np.bincount(inv)
    maj = int(np.argmax(counts))
    if counts[maj] < 0.5 * inv.size:
        return None, None, None
    spec = np.nonzero(inv != maj)[0].astype(np.int32)
    return (
        jnp.asarray(inv.astype(np.int32)),
        jnp.asarray(np.int32(maj)),
        jnp.asarray(spec),
    )


def _group_apply(
    M: jax.Array,
    x: jax.Array,
    onehot: jax.Array,
    group: jax.Array | None = None,
    maj=None,
    spec_idx: jax.Array | None = None,
    precision: str = "highest",
) -> jax.Array:
    """y[d] = M[group(d)] @ x[d].

    With majority metadata (uniform-ish partitions): one shared matmul for
    every domain + a gathered per-matrix correction for the sorted special
    rows.  Otherwise: small nu (good dedup) does one matmul per unique
    matrix then a one-hot combine -- but that intermediate is
    O(nu*ndom*out) and QUADRATIC in the domain count when dedup finds
    nothing; above nu > ndom/4 gather the per-domain matrix instead
    (memory ~ M itself there) and run one batched einsum."""
    if spec_idx is not None:
        M0 = jnp.take(M, maj, axis=0)  # dynamic single-matrix gather (tiny)
        y = jnp.einsum("di,oi->do", x, M0, precision=precision)
        if spec_idx.shape[0] > 0:
            # recurse on the special subset: the same nu-vs-count heuristic
            # then picks per-row gather (small nspec) or one-hot combine
            # (small nu) -- never a per-ALL-domain matrix stack (the
            # ungated gather held 4 x 535 MB live at nx=1024/block16)
            xs = jnp.take(x, spec_idx, axis=0)
            oh = jnp.take(onehot, spec_idx, axis=1)
            ys = _group_apply(M, xs, oh, precision=precision)
            y = y.at[spec_idx].set(
                ys, unique_indices=True, indices_are_sorted=True
            )
        return y
    nu, ndom = onehot.shape
    if 4 * nu > ndom:
        group = jnp.argmax(onehot, axis=0)  # (ndom,) static one-hot layout
        Mg = jnp.take(M, group, axis=0)
        return jnp.einsum("doi,di->do", Mg, x, precision=precision)
    ys = jnp.einsum("uoi,di->udo", M, x, precision=precision)
    return jnp.einsum("udo,ud->do", ys, onehot, precision=precision)


def _b1_scatter(params: DDHParams, upd_l, upd_m, n_lambda: int, dtype):
    """Write per-domain face updates to the dual trace slots (B1 table,
    last-write-wins set; DDH.cpp:309-319)."""
    has1 = params.B1 >= 0
    idx = jnp.where(has1, params.B1, n_lambda)
    out_l = jnp.zeros(n_lambda + 1, dtype=dtype).at[idx.reshape(-1)].set(
        jnp.where(has1, upd_l, 0.0).reshape(-1).astype(dtype), mode="drop"
    )[:n_lambda]
    out_m = jnp.zeros(n_lambda + 1, dtype=dtype).at[idx.reshape(-1)].set(
        jnp.where(has1, upd_m, 0.0).reshape(-1).astype(dtype), mode="drop"
    )[:n_lambda]
    return jnp.concatenate([out_l, out_m])


class RollRoute(NamedTuple):
    """Roll-based trace exchange for (near-)regular subdomain graphs.

    Discovered generically from the B1 dual table: sender slot k of domain d
    routing to slot sigma(k) of domain d+off for a fixed flat offset ``off``
    can be exchanged with an elementwise mask, a ``jnp.roll`` over the
    domain axis, and a STATIC column gather placing each sender slot at its
    target slot -- pure HBM-bandwidth ops instead of a per-element scatter.
    Several routes may share one offset (each with its own slot map), so
    every sender whose (offset, slot, target-slot) pattern repeats across
    domains is covered; on a structured partition that is ALL of them.
    ``A`` is the transfer matrix with the identity terms folded in, rows at
    the sender slots.  The remainder (writes to overwritten-corner tail ids,
    plus irregular senders on unstructured partitions) goes through one
    small sorted scatter.
    """

    A: jax.Array | None  # (ndom, 2pf, 2pf) identity-folded -I -/+ T
    masks: jax.Array  # (n_route, ndom, 2pf+1) 0/1 sender masks (pad col = 0)
    irr_src: jax.Array  # (n_irr,) int32 flat (ndom*pf) sender index per half
    irr_tgt: jax.Array  # (n_irr,) int32 into the n_lambda-sized side vector
    # majority split (set when >= half the domains share one matrix): the
    # batched matmul becomes one SHARED (2pf, 2pf) matmul + gathered
    # corrections for the special domains -- HBM reads drop from
    # ndom*(2pf)^2 to ~nspec*(2pf)^2
    A0: jax.Array | None  # (2pf, 2pf) shared majority matrix
    A_spec: jax.Array | None  # (nspec, 2pf, 2pf) corrections A[spec] - A0
    spec_idx: jax.Array | None  # (nspec,) sorted int32 special-domain rows
    # the flat domain offsets and target<-source column maps (one per mask
    # row) are passed separately as STATIC tuples so the rolls compile to
    # fixed shifts and the column gathers to layout copies


def _build_roll_route(
    T_u: np.ndarray,
    groups: np.ndarray,
    B1_np: np.ndarray,
    n_own: int,
    max_routes: int = 16,
    min_uniform_frac: float = 0.5,
) -> tuple[RollRoute, tuple, tuple] | None:
    """Discover (offset, slot-map) routes in B1 and build a RollRoute.

    Senders are grouped by (domain offset, sender slot, target slot); groups
    sharing an offset pack greedily into routes with injective slot maps.
    Returns ``(route, offs, perms)`` with ``offs``/``perms`` static tuples,
    or None when fewer than ``min_uniform_frac`` of the senders fit a route
    (very irregular partitions), in which case the scatter exchange stays in
    use.
    """
    from collections import defaultdict

    ndom, pf = B1_np.shape
    d = np.repeat(np.arange(ndom), pf)
    k = np.tile(np.arange(pf), ndom)
    t = B1_np.reshape(-1).astype(np.int64)
    send = t >= 0
    own_t = send & (t < n_own)
    td, tk = np.divmod(np.where(own_t, t, 0), pf)
    off_all = td - d

    # group senders by (offset, sender slot, target slot) -- vectorised via a
    # composite-integer unique (the per-sender Python loop this replaces was
    # O(n_own) dict churn: minutes at nx=512's 3M senders)
    flat = np.nonzero(own_t)[0]
    if flat.size == 0:
        return None
    offf = off_all[flat]
    omin = int(offf.min())
    key = ((offf - omin).astype(np.int64) * pf + k[flat]) * pf + tk[flat]
    order = np.argsort(key, kind="stable")
    uk, starts, counts = np.unique(
        key[order], return_index=True, return_counts=True
    )
    tt_u = (uk % pf).astype(np.int64)
    kk_u = ((uk // pf) % pf).astype(np.int64)
    off_u = (uk // (pf * pf)).astype(np.int64) + omin

    def members_of(gi: int) -> np.ndarray:
        s = starts[gi]
        return flat[order[s : s + counts[gi]]]

    # pack groups into routes: per route one offset + an injective slot map
    per_off: dict = defaultdict(list)  # off -> [(used_k, used_t, members)]
    for gi in np.argsort(-counts, kind="stable"):
        o, kk, tt = int(off_u[gi]), int(kk_u[gi]), int(tt_u[gi])
        for sk, st, members in per_off[o]:
            if kk not in sk and tt not in st:
                sk.add(kk)
                st.add(tt)
                members[kk] = (tt, gi)
                break
        else:
            per_off[o].append(({kk}, {tt}, {kk: (tt, gi)}))

    route_list = [
        (o, members) for o, lst in per_off.items() for _, _, members in lst
    ]
    route_list.sort(key=lambda om: -sum(counts[gi] for _, gi in om[1].values()))
    route_list = route_list[:max_routes]

    covered = np.zeros(ndom * pf, bool)
    offs: list[int] = []
    perms: list[tuple] = []
    masks = np.zeros((len(route_list), ndom, 2 * pf + 1), np.float32)
    for i, (o, members) in enumerate(route_list):
        # column map: target slot c <- sender slot perm[c]; uncovered target
        # slots read the zero pad column (index 2pf)
        perm = np.full(2 * pf, 2 * pf, np.int64)
        for kk, (tt, gi) in members.items():
            perm[tt] = kk
            perm[pf + tt] = pf + kk
            ii = members_of(gi)
            masks[i, ii // pf, kk] = 1.0
            masks[i, ii // pf, pf + kk] = 1.0
            covered[ii] = True
        offs.append(int(o))
        perms.append(tuple(int(c) for c in perm))

    n_uniform = int(covered.sum())
    if n_uniform < min_uniform_frac * int(send.sum()):
        return None

    # A = identity-folded (-I -/+ T), rows at the sender slots (row i<pf
    # gives -x_l - w_l, row i>=pf gives -x_m + w_m) -- built at the DEDUPED
    # nu level; the full per-domain stack is only expanded in the
    # no-majority fallback
    T_u = np.asarray(T_u)
    A_u = np.concatenate([-T_u[:, :pf, :], T_u[:, pf:, :]], axis=1)
    A_u[:, np.arange(2 * pf), np.arange(2 * pf)] -= 1.0

    irr = np.nonzero(send & ~covered)[0]
    irr = irr[np.argsort(t[irr], kind="stable")]  # sorted scatter targets
    irr_src = irr.astype(np.int32)
    irr_tgt = t[irr].astype(np.int32)

    # majority split: one shared matrix + gathered corrections for the
    # special rows (arrays keep T's dtype so an fp64 DDH stays fp64)
    dt = T_u.dtype
    A0 = A_spec = spec_idx = None
    A_full = None
    counts = np.bincount(groups)
    maj = int(np.argmax(counts))
    if counts[maj] >= 0.5 * ndom:
        A0 = jnp.asarray(A_u[maj], dt)
        spec = np.nonzero(groups != maj)[0]
        if spec.size:
            A_spec = jnp.asarray(A_u[groups[spec]] - A_u[maj][None], dt)
            spec_idx = jnp.asarray(spec.astype(np.int32))
    else:
        A_full = jnp.asarray(A_u[groups], dt)

    route = RollRoute(
        A=A_full,
        # bf16: the masks are exact 0/1 and promote back to the data dtype
        # at the multiply; fp32 storage was 406 MB at nx=1024/block16
        masks=jnp.asarray(masks, jnp.bfloat16),
        irr_src=jnp.asarray(irr_src),
        irr_tgt=jnp.asarray(irr_tgt),
        A0=A0,
        A_spec=A_spec,
        spec_idx=spec_idx,
    )
    return route, tuple(offs), tuple(perms)


# ---------------------------------------------------------------- pure kernels


def _apply_S(S: jax.Array, p: jax.Array, precision=PRECISION) -> jax.Array:
    """z = S p batched over subdomains (S shared (pad,pad) or per-domain).

    When ``p`` carries ``c`` probe columns per matrix (rows ordered
    (c, nu, pad) flattened, as the precompute chunks build them), the
    deduped (nu, pad, pad) stack is BROADCAST over the column axis: each
    time step then reads S once and runs (c, pad) x (pad, pad) batched
    matmuls instead of bandwidth-bound batch-1 matvecs against a tiled
    (c*nu, pad, pad) stack.
    """
    if S.ndim == 2:
        return jax.lax.dot_general(
            p,
            S,
            (((1,), (1,)), ((), ())),
            preferred_element_type=p.dtype,
            precision=precision,
        )
    if S.shape[0] != p.shape[0]:
        c = p.shape[0] // S.shape[0]
        pc = p.reshape(c, S.shape[0], p.shape[1])
        z = jnp.einsum("cdj,dij->cdi", pc, S, precision=precision)
        return z.reshape(p.shape)
    return jnp.einsum("dij,dj->di", S, p, precision=precision)


def _read_traces(
    params: DDHParams,
    lam,
    n_lambda: int,
    n_own: int,
    n_own_pad: int | None = None,
    dom_offset=None,
):
    """Own-side compact traces (lam0, mu0) as masked RESHAPES of lam.

    The own-slot lambda layout makes a surviving trace unknown's id equal to
    its (d*pf + k) compact slot position, so no gather is needed.  When the
    subdomain batch is row-sharded, ``dom_offset`` (a traced axis offset) and
    ``n_own_pad`` (the padded total own size, static) select this chip's
    contiguous row block with one dynamic slice.
    """
    ndom, pf = params.B0.shape
    lam_g, mu_g = lam[:n_lambda], lam[n_lambda:]
    if dom_offset is None:
        lam0 = lam_g[:n_own].reshape(ndom, pf)
        mu0 = mu_g[:n_own].reshape(ndom, pf)
    else:
        padn = n_own_pad - n_own
        lo = jnp.pad(lam_g[:n_own], (0, padn))
        mo = jnp.pad(mu_g[:n_own], (0, padn))
        start = dom_offset * pf
        lam0 = lax.dynamic_slice_in_dim(lo, start, ndom * pf).reshape(ndom, pf)
        mu0 = lax.dynamic_slice_in_dim(mo, start, ndom * pf).reshape(ndom, pf)
    has = params.B0 >= 0
    return jnp.where(has, lam0, 0.0), jnp.where(has, mu0, 0.0)


def _forcing(
    params: DDHParams,
    x,
    lam,
    g_ndof: int,
    n_own: int | None = None,
    n_own_pad: int | None = None,
    dom_offset=None,
):
    """Gather forcing and lambda traces into subdomain slots.

    Returns F, G (ndom, pad) and the COMPACT own-trace values lam0, mu0
    ((ndom, pf), aligned with fslot/B0/B1) used by the transmission update.
    All trace indexing runs on the compact face-slot arrays.
    """
    gI_safe = jnp.maximum(params.gI, 0)
    zero = jnp.zeros_like(params.gmask)
    if x is not None:
        x = x.astype(params.gmask.dtype)
        F = params.F_weight * x[gI_safe]
        G = params.F_weight * x[g_ndof + gI_safe]
    else:
        F, G = zero, zero
    if lam is not None and lam.shape[0] > 0:
        n_lam = lam.shape[0] // 2
        lam0, mu0 = _read_traces(params, lam, n_lam, n_own, n_own_pad, dom_offset)
        # embed H*lam0 at the face slots; padded rows carry Hf == 0 so the
        # clamped slot-0 adds are exact no-ops
        ndom, pad = F.shape
        fs = jnp.maximum(params.fslot, 0)
        flat = (jnp.arange(ndom, dtype=jnp.int32)[:, None] * pad + fs).reshape(-1)
        F = (
            F.reshape(-1).at[flat].add((params.Hf * lam0).reshape(-1))
        ).reshape(ndom, pad)
        G = (
            G.reshape(-1).at[flat].add((params.Hf * mu0).reshape(-1))
        ).reshape(ndom, pad)
    else:
        lam0 = jnp.zeros_like(params.Hf)
        mu0 = jnp.zeros_like(params.Hf)
    return F, G, lam0, mu0


def _wave_cycle_xla(
    params: DDHParams, F, G, wh_maxit: int = WH_MAXIT, precision=PRECISION
):
    """The wh_maxit x nt staggered-leapfrog WaveHoltz cycle (DDH.cpp:237-293)."""
    dt = params.dt
    half_dt = 0.5 * dt
    S, Ha, inv_mi = params.S, params.Ha, params.inv_mi

    def step(carry, row):
        p, q, u, v = carry
        cs0, sn0, cs1, sn1, Kt = row[0], row[1], row[2], row[3], row[4]
        z = _apply_S(S, p, precision) - Ha * q
        dq = (z + cs0 * F + sn0 * G) * inv_mi
        p_half = p - half_dt * q
        q_half = q + half_dt * dq
        p2 = p - dt * q_half
        z2 = _apply_S(S, p_half, precision) - Ha * q_half
        dq2 = (z2 + cs1 * F + sn1 * G) * inv_mi
        q2 = q + dt * dq2
        return (p2, q2, u + Kt * p2, v + Kt * q2), None

    def wh_iter(carry, _):
        u, v = carry
        p, q = u, v
        u0, v0 = params.K0 * u, params.K0 * v
        (p, q, u, v), _ = lax.scan(step, (p, q, u0, v0), params.tables)
        return (u, v), None

    z = jnp.zeros_like(F)
    (u, v), _ = lax.scan(wh_iter, (z, z), None, length=wh_maxit)
    return u, v


def _probe_cycle(p: DDHParams, Ha_u, mi_u, S_u, Fb, Gb, wh_maxit, precision):
    """Wave cycle of ``c`` probe columns on each of the ``nu`` unique
    domains: (c, nu, pad) forcing pairs -> (u, v / omega), same shape.  The
    deduped S stack broadcasts over the columns in ``_apply_S``."""
    c, nu, pad = Fb.shape
    p2 = p._replace(Ha=jnp.tile(Ha_u, (c, 1)), inv_mi=jnp.tile(mi_u, (c, 1)), S=S_u)
    u, v = _wave_cycle_xla(
        p2, Fb.reshape(c * nu, pad), Gb.reshape(c * nu, pad), wh_maxit, precision
    )
    return u.reshape(c, nu, pad), v.reshape(c, nu, pad) / p.omega


def _scatter_updates(params: DDHParams, lam0, mu0, u, v, n_lambda: int):
    """Transmission update written to the dual trace slots (DDH.cpp:309-319).

    lam0/mu0 are compact (ndom, pf); u, v are full (ndom, pad) subdomain
    state -- their face values are gathered through fslot.
    """
    fs = jnp.maximum(params.fslot, 0)
    uf = jnp.take_along_axis(u, fs, axis=1)
    vf = jnp.take_along_axis(v, fs, axis=1)
    has = params.B1 >= 0
    idx = jnp.where(has, params.B1, n_lambda)
    lam_upd = -lam0 - params.a2wf * vf
    mu_upd = -mu0 + params.a2wf * uf
    out_l = jnp.zeros(n_lambda + 1, dtype=u.dtype).at[idx.reshape(-1)].set(
        jnp.where(has, lam_upd, 0.0).reshape(-1), mode="drop"
    )[:n_lambda]
    out_m = jnp.zeros(n_lambda + 1, dtype=u.dtype).at[idx.reshape(-1)].set(
        jnp.where(has, mu_upd, 0.0).reshape(-1), mode="drop"
    )[:n_lambda]
    return jnp.concatenate([out_l, out_m])


def _scatter_solution(params: DDHParams, u, v, g_ndof: int):
    w = params.m_gmi
    gI_safe = jnp.where(params.gI >= 0, params.gI, g_ndof)
    yu = jnp.zeros(g_ndof + 1, dtype=u.dtype).at[gI_safe.reshape(-1)].add(
        (w * u).reshape(-1), mode="drop"
    )[:g_ndof]
    yv = jnp.zeros(g_ndof + 1, dtype=u.dtype).at[gI_safe.reshape(-1)].add(
        (w * v).reshape(-1), mode="drop"
    )[:g_ndof]
    return jnp.concatenate([yu, yv])


@partial(jax.jit, static_argnames=("n_own", "wh_maxit", "precision"))
def ddh_action(
    params: DDHParams,
    lam: jax.Array,
    n_own: int | None = None,
    wh_maxit: int = WH_MAXIT,
    precision: str = PRECISION,
):
    """lambda - S(lambda): fixed-point form of the substructured system."""
    n_lambda = lam.shape[0] // 2
    if n_own is None:
        n_own = params.B0.shape[0] * params.B0.shape[1]
    F, G, lam0, mu0 = _forcing(params, None, lam, 0, n_own)
    u, v = _wave_cycle_xla(params, F, G, wh_maxit, precision)
    v = v / params.omega
    upd = _scatter_updates(params, lam0, mu0, u, v, n_lambda)
    return lam - upd


def _transfer_update(
    params: DDHParams,
    T: jax.Array,
    lam: jax.Array,
    n_lambda: int,
    n_own: int,
    n_own_pad: int | None = None,
    dom_offset=None,
):
    """Transmission update S(lambda) via the per-subdomain transfer matrices.

    Shared by the single-chip apply and the subdomain-sharded apply (where
    params/T hold this chip's subdomain rows and the caller psums the result).
    """
    pf = params.Hf.shape[1]
    lam0, mu0 = _read_traces(params, lam, n_lambda, n_own, n_own_pad, dom_offset)
    lam0 = lam0.astype(T.dtype)
    mu0 = mu0.astype(T.dtype)
    x = jnp.concatenate([lam0, mu0], axis=1)  # (ndom, 2pf)
    w = jnp.einsum("dik,dk->di", T, x, precision="highest")  # true fp32
    upd_l = -lam0 - w[:, :pf]
    upd_m = -mu0 + w[:, pf:]
    return _b1_scatter(params, upd_l, upd_m, n_lambda, lam.dtype)


def _transfer_matmul(route: RollRoute, x: jax.Array) -> jax.Array:
    """u2 = A x batched over subdomains (shared-majority split when set)."""
    if route.A0 is not None:
        # shared majority matmul + gathered per-domain corrections (sorted
        # unique indices: the gather/scatter are layout copies)
        u2 = jax.lax.dot_general(
            x, route.A0, (((1,), (1,)), ((), ())), precision="highest"
        )
        if route.A_spec is not None:
            xs = x[route.spec_idx]
            ws = jnp.einsum("sik,sk->si", route.A_spec, xs, precision="highest")
            u2 = u2.at[route.spec_idx].add(
                ws.astype(u2.dtype), unique_indices=True, indices_are_sorted=True
            )
        return u2
    return jnp.einsum("dik,dk->di", route.A, x, precision="highest")


@partial(jax.jit, static_argnames=("n_own", "offs", "perms"))
def ddh_action_transfer_rolled(
    params: DDHParams,
    route: RollRoute,
    lam: jax.Array,
    n_own: int,
    offs: tuple,
    perms: tuple,
):
    """lambda - S(lambda) with the roll-based trace exchange.

    One batched (ndom, 2pf) @ (2pf, 2pf) matmul against the identity-folded
    transfer matrix; sender groups are routed with elementwise masks +
    ``jnp.roll`` over the domain axis + a static column gather per route
    (HBM-bandwidth ops), the remainder (tail writes, irregular senders) with
    one small sorted scatter per side.  Algebraically identical to
    ``ddh_action_transfer``.
    """
    n_lambda = lam.shape[0] // 2
    ndom, pf = params.B0.shape
    lam0, mu0 = _read_traces(params, lam, n_lambda, n_own)
    dt_A = route.A0.dtype if route.A0 is not None else route.A.dtype
    x = jnp.concatenate([lam0, mu0], axis=1).astype(dt_A)
    u2 = _transfer_matmul(route, x)
    u2p = jnp.pad(u2, ((0, 0), (0, 1)))  # zero pad column for dead slots
    out_own = jnp.zeros_like(u2)
    for i, (off, perm) in enumerate(zip(offs, perms)):
        mu = route.masks[i] * u2p
        out_own = out_own + jnp.roll(mu, off, axis=0)[:, np.asarray(perm)]
    n_lost = n_lambda - n_own
    tail = jnp.zeros(n_lost, dtype=lam.dtype)
    out_l = jnp.concatenate([out_own[:, :pf].reshape(-1).astype(lam.dtype), tail])
    out_m = jnp.concatenate([out_own[:, pf:].reshape(-1).astype(lam.dtype), tail])
    if route.irr_src.shape[0] > 0:
        vals_l = u2[:, :pf].reshape(-1)[route.irr_src].astype(lam.dtype)
        vals_m = u2[:, pf:].reshape(-1)[route.irr_src].astype(lam.dtype)
        out_l = out_l.at[route.irr_tgt].set(
            vals_l, mode="drop", unique_indices=True, indices_are_sorted=True
        )
        out_m = out_m.at[route.irr_tgt].set(
            vals_m, mode="drop", unique_indices=True, indices_are_sorted=True
        )
    return lam - jnp.concatenate([out_l, out_m])


@partial(jax.jit, static_argnames=("n_own",))
def ddh_action_transfer(params: DDHParams, T: jax.Array, lam: jax.Array, n_own: int):
    """lambda - S(lambda) via the precomputed per-subdomain transfer matrices.

    Algebraically identical to ``ddh_action`` (the cycle is linear in the
    traces); each apply is one batched (ndom, 2pf) @ (2pf, 2pf) matmul plus
    the trace exchange, instead of wh_maxit*nt*2 stiffness matmuls.
    """
    n_lambda = lam.shape[0] // 2
    return lam - _transfer_update(params, T, lam, n_lambda, n_own)


@partial(
    jax.jit,
    static_argnames=("g_ndof", "n_lambda", "wh_maxit", "precision"),
)
def ddh_rhs(
    params: DDHParams,
    f: jax.Array,
    g_ndof: int,
    n_lambda: int,
    wh_maxit: int = WH_MAXIT,
    precision: str = PRECISION,
):
    """b: transmission traces generated by the volume forcing alone."""
    F, G, lam0, mu0 = _forcing(params, f, None, g_ndof)
    u, v = _wave_cycle_xla(params, F, G, wh_maxit, precision)
    v = v / params.omega
    return _scatter_updates(params, lam0, mu0, u, v, n_lambda)


@partial(
    jax.jit,
    static_argnames=("g_ndof", "n_own", "wh_maxit", "precision"),
)
def ddh_postprocess(
    params: DDHParams,
    lam: jax.Array,
    f: jax.Array,
    g_ndof: int,
    n_own: int | None = None,
    wh_maxit: int = WH_MAXIT,
    precision: str = PRECISION,
):
    """Recover [u; v] from the substructured solution and the forcing."""
    if n_own is None:
        n_own = params.B0.shape[0] * params.B0.shape[1]
    F, G, _, _ = _forcing(params, f, lam, g_ndof, n_own)
    u, v = _wave_cycle_xla(params, F, G, wh_maxit, precision)
    v = v / params.omega
    return _scatter_solution(params, u, v, g_ndof)


@partial(jax.jit, static_argnames=("g_ndof", "n_lambda", "precision"))
def ddh_rhs_io(
    params: DDHParams, io: IOMaps, f: jax.Array, g_ndof: int, n_lambda: int,
    precision: str = "highest",
):
    """``ddh_rhs`` via the precomputed forcing->trace map: no wave cycle
    executes (algebraically identical -- the cycle is linear in (F, G))."""
    F, G, _, _ = _forcing(params, f, None, g_ndof)
    pf = params.Hf.shape[1]
    x = jnp.concatenate([F, G], axis=1).astype(io.R.dtype)
    w = _group_apply(
        io.R, x, io.onehot, io.group, io.maj, io.spec_idx, precision=precision
    )
    return _b1_scatter(params, -w[:, :pf], w[:, pf:], n_lambda, x.dtype)


@partial(jax.jit, static_argnames=("g_ndof", "n_own", "precision"))
def ddh_postprocess_io(
    params: DDHParams,
    io: IOMaps,
    lam: jax.Array,
    f: jax.Array,
    g_ndof: int,
    n_own: int,
    precision: str = "highest",
):
    """``ddh_postprocess`` via the precomputed (forcing, trace)->solution
    maps: u = Pu.[F;G] + Pul.[lam0;mu0] (likewise v), then the mass-weighted
    global scatter."""
    F, G, _, _ = _forcing(params, f, None, g_ndof)
    n_lambda = lam.shape[0] // 2
    lam0, mu0 = _read_traces(params, lam, n_lambda, n_own)
    x = jnp.concatenate([F, G], axis=1).astype(io.Pu.dtype)
    tr = jnp.concatenate([lam0, mu0], axis=1).astype(io.Pu.dtype)
    ga = lambda M, z: _group_apply(
        M, z, io.onehot, io.group, io.maj, io.spec_idx, precision=precision
    )
    u = ga(io.Pu, x) + ga(io.Pul, tr)
    v = ga(io.Pv, x) + ga(io.Pvl, tr)
    return _scatter_solution(params, u, v, g_ndof)
