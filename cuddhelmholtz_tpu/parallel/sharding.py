"""Multi-device execution: shard elements and subdomains over a device mesh.

The reference is strictly single-GPU (SURVEY.md section 2: no MPI/NCCL).
Here, over a 1-D mesh of the cards of one host (joined all to all, so the
mesh follows the algorithm alone):

  * **Operators (element parallel)**: elements are row-sharded over the mesh
    axis; each device gathers from a replicated global vector, applies its
    element batch, scatter-adds into a full-length local accumulator, and a
    ``psum`` completes the CG assembly.  For the problem sizes this
    framework targets (<= a few M DOF), the replicated vector +
    psum-assembly layout avoids halo bookkeeping entirely.
  * **DDH (subdomain parallel)**: subdomains are row-sharded; the lambda
    (interface trace) vector is small (O(n_shared)) and kept replicated;
    each device applies the transfer matrices (or runs the wave cycle) for
    its subdomain block and the transmission updates are combined with a
    single small ``psum`` -- the analog of the reference's
    single-kernel-exit lambda exchange.
  * GMRES dot products reduce with ``psum`` automatically because the Krylov
    vectors here stay replicated (lambda system) while the expensive matvec
    is subdomain-sharded.

Everything is built on ``shard_map`` over an explicit ``jax.sharding.Mesh``;
XLA lowers the collectives to NCCL on GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.helmholtz import HelmholtzOp
from ..ops.face_mass import apply_face_mass
from ..ops.mass import MassOp
from ..ops.stiffness import StiffnessOp
from ..solvers.ddh import (
    DDH,
    DDHParams,
    _forcing,
    _read_traces,
    _scatter_solution,
    _scatter_updates,
    _transfer_update,
    _wave_cycle_xla,
)


def device_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _axes_tuple(axis) -> tuple[str, ...]:
    """Normalise an axis argument (one name or a tuple, e.g. ('dcn', 'ici'))."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh_axis_size(mesh: Mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _flat_axis_index(mesh: Mesh, axes: tuple[str, ...]):
    """Row-major flat index of this shard over possibly-multiple mesh axes
    (outer axes major, e.g. dcn-major so an ici block holds contiguous
    subdomain rows)."""
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def _pad_rows(a: np.ndarray | jax.Array, rows: int):
    if a.shape[0] == rows:
        return a
    pad = rows - a.shape[0]
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(jnp.asarray(a), widths)


def shard_stiffness_op(op: StiffnessOp, mesh: Mesh, axis: str = "shard") -> StiffnessOp:
    """Row-shard the element-batched arrays of a stiffness operator."""
    n = mesh.shape[axis]
    nel = op.dofs.shape[0]
    nel_pad = ((nel + n - 1) // n) * n
    sh = NamedSharding(mesh, P(axis))

    def place(a):
        a = _pad_rows(a, nel_pad)
        return jax.device_put(a, sh)

    # padded elements scatter into DOF slot `ndof` (dropped)
    dofs = jnp.asarray(op.dofs)
    if nel_pad != nel:
        fill = jnp.full((nel_pad - nel,) + op.dofs.shape[1:], op.ndof, jnp.int32)
        dofs = jnp.concatenate([dofs, fill])
    return StiffnessOp(
        dofs=jax.device_put(dofs, sh),
        P=op.P,
        D=op.D,
        A=place(op.A),
        B=place(op.B),
        C=place(op.C),
        ndof=op.ndof,
    )


def sharded_stiffness_apply(op: StiffnessOp, mesh: Mesh, axis: str = "shard"):
    """Build a jittable y = S x with elements sharded over ``mesh``.

    x and y are replicated; the per-device partial assembly is combined with
    one psum.
    """

    ndof = op.ndof

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P(), P(axis), P(axis), P(axis), P()),
        out_specs=P(),
    )
    def apply_fn(dofs, Pm, Dm, A, B, C, x):
        xe = jnp.take(x, dofs, axis=0, mode="fill", fill_value=0.0)
        tP = jnp.einsum("qi,eji->ejq", Pm, xe)
        tD = jnp.einsum("qi,eji->ejq", Dm, xe)
        ux = jnp.einsum("rj,ejq->erq", Pm, tD)
        uy = jnp.einsum("rj,ejq->erq", Dm, tP)
        fx = A * ux + B * uy
        fy = B * ux + C * uy
        sx = jnp.einsum("qi,erq->eri", Dm, fx)
        sy = jnp.einsum("qi,erq->eri", Pm, fy)
        ye = jnp.einsum("rj,eri->eji", Pm, sx) + jnp.einsum("rj,eri->eji", Dm, sy)
        y = jnp.zeros(ndof + 1, x.dtype).at[dofs.reshape(-1)].add(
            ye.reshape(-1), mode="drop"
        )[:ndof]
        return jax.lax.psum(y, axis)

    return lambda sharded_op, x: apply_fn(
        sharded_op.dofs, sharded_op.P, sharded_op.D, sharded_op.A, sharded_op.B,
        sharded_op.C, x,
    )


def shard_mass_op(op: MassOp, mesh: Mesh, axis: str = "shard") -> MassOp:
    """Row-shard the element-batched arrays of a (weighted) mass operator."""
    n = mesh.shape[axis]
    nel = op.dofs.shape[0]
    nel_pad = ((nel + n - 1) // n) * n
    sh = NamedSharding(mesh, P(axis))
    dofs = jnp.asarray(op.dofs)
    if nel_pad != nel:
        fill = jnp.full((nel_pad - nel,) + op.dofs.shape[1:], op.ndof, jnp.int32)
        dofs = jnp.concatenate([dofs, fill])
    return MassOp(
        dofs=jax.device_put(dofs, sh),
        P=op.P,
        wdetj=jax.device_put(_pad_rows(op.wdetj, nel_pad), sh),
        ndof=op.ndof,
    )


def sharded_mass_apply(op: MassOp, mesh: Mesh, axis: str = "shard"):
    """Build a jittable y = M x with elements sharded over ``mesh``."""
    ndof = op.ndof

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P()),
        out_specs=P(),
    )
    def apply_fn(dofs, Pq, wdetj, x):
        xe = jnp.take(x, dofs, axis=0, mode="fill", fill_value=0.0)
        t = jnp.einsum("qi,eji->ejq", Pq, xe)
        u = jnp.einsum("rj,ejq->erq", Pq, t) * wdetj
        t = jnp.einsum("qi,erq->eri", Pq, u)
        ye = jnp.einsum("rj,eri->eji", Pq, t)
        y = jnp.zeros(ndof + 1, x.dtype).at[dofs.reshape(-1)].add(
            ye.reshape(-1), mode="drop"
        )[:ndof]
        return jax.lax.psum(y, axis)

    return lambda sharded_op, x: apply_fn(
        sharded_op.dofs, sharded_op.P, sharded_op.wdetj, x
    )


def sharded_helmholtz_matvec(
    op: HelmholtzOp, mesh: Mesh, axis: str = "shard"
) -> Callable:
    """Element-sharded coupled Helmholtz action (the global-system analog of
    ShardedDDH for BASELINE config 5: high-frequency sweep, multi-host
    partitioned).

    The stiffness and weighted-mass element batches are row-sharded; one
    ``shard_map`` computes both volume partials for the stacked (u, v) pair
    and combines them with a single ``psum`` of a (2, ndof) stack.
    The face-mass boundary terms act on O(sqrt(ndof)) DOFs and stay
    replicated.  Returns a jittable ``U -> A U`` closure over the sharded
    operator data; U is replicated (the GMRES basis layout).
    """
    if op.stiffness is None or op.mass is None:
        raise ValueError(
            "sharded_helmholtz_matvec needs the generic element-batched "
            "operators; build the op with make_helmholtz_op(..., kron=False)"
        )
    sop = shard_stiffness_op(op.stiffness, mesh, axis)
    mop = shard_mass_op(op.mass, mesh, axis)
    ndof = op.ndof
    w2 = op.omega * op.omega

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(axis), P(), P(), P(axis), P(axis), P(axis),  # stiffness
            P(axis), P(), P(axis),  # mass
            P(),  # UV (2, ndof) replicated
        ),
        out_specs=P(),
    )
    def volume_fn(sd, Pm, Dm, A, B, C, md, Pq, wdetj, UV):
        xs = jnp.take(UV, sd, axis=1, mode="fill", fill_value=0.0)  # (2,e,j,i)
        tP = jnp.einsum("qi,ceji->cejq", Pm, xs)
        tD = jnp.einsum("qi,ceji->cejq", Dm, xs)
        ux = jnp.einsum("rj,cejq->cerq", Pm, tD)
        uy = jnp.einsum("rj,cejq->cerq", Dm, tP)
        fx = A * ux + B * uy
        fy = B * ux + C * uy
        sx = jnp.einsum("qi,cerq->ceri", Dm, fx)
        sy = jnp.einsum("qi,cerq->ceri", Pm, fy)
        ys = jnp.einsum("rj,ceri->ceji", Pm, sx) + jnp.einsum(
            "rj,ceri->ceji", Dm, sy
        )
        xm = jnp.take(UV, md, axis=1, mode="fill", fill_value=0.0)
        t = jnp.einsum("qi,ceji->cejq", Pq, xm)
        um = jnp.einsum("rj,cejq->cerq", Pq, t) * wdetj
        t = jnp.einsum("qi,cerq->ceri", Pq, um)
        ym = jnp.einsum("rj,ceri->ceji", Pq, t)
        y = jnp.zeros((2, ndof + 1), UV.dtype)
        y = y.at[:, sd.reshape(-1)].add(ys.reshape(2, -1), mode="drop")
        y = y.at[:, md.reshape(-1)].add(
            (-w2 * ym).reshape(2, -1), mode="drop"
        )
        return jax.lax.psum(y[:, :ndof], axis)

    def matvec(U):
        UV = jnp.stack([U[:ndof], U[ndof:]])
        Y = volume_fn(
            sop.dofs, sop.P, sop.D, sop.A, sop.B, sop.C,
            mop.dofs, mop.P, mop.wdetj, UV,
        )
        uf = jnp.take(U[:ndof], op.face_proj)
        vf = jnp.take(U[ndof:], op.face_proj)
        Hu = apply_face_mass(op.face_mass, uf)
        Hv = apply_face_mass(op.face_mass, vf)
        Au = Y[0].at[op.face_proj].add(-op.omega * Hv)
        Av = -(Y[1].at[op.face_proj].add(op.omega * Hu))
        return jnp.concatenate([Au, Av])

    return matvec


class ShardedDDH:
    """Subdomain-sharded DDH: same action/rhs/postprocess API as ``DDH``.

    Pads the subdomain batch to a multiple of the mesh axis and row-shards
    every (ndom, pad) table; lambda vectors stay replicated.
    """

    def __init__(
        self,
        ddh: DDH,
        mesh: Mesh,
        axis: str | tuple = "shard",
    ):
        self.mesh = mesh
        self.axis = axis
        axes = _axes_tuple(axis)
        self.axes = axes
        self.inner = ddh
        n = _mesh_axis_size(mesh, axes)
        p = ddh.params
        ndom = p.gI.shape[0]
        ndom_pad = ((ndom + n - 1) // n) * n
        sh = NamedSharding(mesh, P(axes))
        rep = NamedSharding(mesh, P())

        def place_rows(a, fill=0):
            a = jnp.asarray(a)
            if ndom_pad != ndom:
                padw = [(0, ndom_pad - ndom)] + [(0, 0)] * (a.ndim - 1)
                a = jnp.pad(a, padw, constant_values=fill)
            return jax.device_put(a, sh)

        per_dom_S = p.S.ndim == 3
        self.params = DDHParams(
            S=place_rows(p.S) if per_dom_S else jax.device_put(p.S, rep),
            gI=place_rows(p.gI, fill=-1),
            gmask=place_rows(p.gmask),
            F_weight=place_rows(p.F_weight),
            Ha=place_rows(p.Ha),
            inv_mi=place_rows(p.inv_mi),
            m_gmi=place_rows(p.m_gmi),
            fslot=place_rows(p.fslot, fill=-1),
            Hf=place_rows(p.Hf),
            a2wf=place_rows(p.a2wf),
            B0=place_rows(p.B0, fill=-1),
            B1=place_rows(p.B1, fill=-1),
            tables=jax.device_put(p.tables, rep),
            K0=jax.device_put(p.K0, rep),
            dt=jax.device_put(p.dt, rep),
            omega=jax.device_put(p.omega, rep),
        )
        spec_S = P(axes) if per_dom_S else P()
        self._param_spec = DDHParams(
            S=spec_S,
            gI=P(axes),
            gmask=P(axes),
            F_weight=P(axes),
            Ha=P(axes),
            inv_mi=P(axes),
            m_gmi=P(axes),
            fslot=P(axes),
            Hf=P(axes),
            a2wf=P(axes),
            B0=P(axes),
            B1=P(axes),
            tables=P(),
            K0=P(),
            dt=P(),
            omega=P(),
        )
        self.g_ndof = ddh.g_ndof
        self.n_lambda = ddh.n_lambda
        self.size = ddh.size
        self.wh_maxit = ddh.wh_maxit
        self._dtype = ddh.dtype

        axes_ = axes
        wh = ddh.wh_maxit
        g_ndof = ddh.g_ndof
        n_lambda = ddh.n_lambda
        precision = ddh.precision
        n_own = ddh.n_own
        pf = ddh.params.Hf.shape[1]
        ndom_local = ndom_pad // n
        n_own_pad = ndom_pad * pf

        def _offset():
            # this device's first subdomain row (own-slot lambda ids are
            # contiguous per row, so the trace read is one dynamic slice)
            return _flat_axis_index(mesh, axes_) * ndom_local

        # row-shard the precomputed trace-transfer (scattering) matrices when
        # the inner DDH has them: the lambda matvec is then one small batched
        # matmul per device + one psum, instead of a full wave cycle
        self.T = place_rows(ddh.T) if ddh.use_transfer else None
        self.use_transfer = self.T is not None

        # halo-exchange (ppermute) variant of the rolled trace exchange: the
        # uniform sender routes become local rolls whose boundary rows ride
        # to the neighbouring device, instead of replicating the full
        # lambda update with a big psum.  Requires every route offset to fit
        # within one device's subdomain block.
        self.route_offs = ()
        self.route_perms = ()
        self._roll_data = None
        if ddh.use_transfer and ddh.route is not None and len(axes) == 1:
            route = ddh.route
            offs = ddh.route_offs
            if all(abs(o) <= ndom_local for o in offs):
                if route.A is not None:
                    A_full = np.asarray(route.A)
                else:
                    A_full = np.repeat(np.asarray(route.A0)[None], ndom, 0)
                    if route.A_spec is not None:
                        spec = np.asarray(route.spec_idx)
                        A_full[spec] += np.asarray(route.A_spec)
                masks = np.asarray(route.masks)
                masks = np.pad(masks, ((0, 0), (0, ndom_pad - ndom), (0, 0)))
                # per-shard padded irregular lists (local flat sender index
                # per half, global lambda target; globally target-sorted so
                # each shard's list stays sorted)
                irr_src = np.asarray(route.irr_src)
                irr_tgt = np.asarray(route.irr_tgt)
                shard_of = (irr_src // pf) // ndom_local
                mx_irr = max(
                    1, int(np.bincount(shard_of, minlength=n).max())
                )
                irr_ls = np.zeros((n, mx_irr), np.int32)
                irr_t = np.full((n, mx_irr), ddh.n_lambda, np.int32)  # dropped
                fill = np.zeros(n, np.int64)
                for s_, src_, tgt_ in zip(shard_of, irr_src, irr_tgt):
                    irr_ls[s_, fill[s_]] = src_ - s_ * ndom_local * pf
                    irr_t[s_, fill[s_]] = tgt_
                    fill[s_] += 1
                self.route_offs = tuple(offs)
                self.route_perms = tuple(ddh.route_perms)
                self._roll_data = (
                    place_rows(jnp.asarray(A_full)),  # keeps the DDH dtype
                    jax.device_put(
                        jnp.asarray(masks), NamedSharding(mesh, P(None, axis))
                    ),
                    jax.device_put(
                        jnp.asarray(irr_ls), NamedSharding(mesh, P(axis))
                    ),
                    jax.device_put(
                        jnp.asarray(irr_t), NamedSharding(mesh, P(axis))
                    ),
                )

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(self._param_spec, P()),
            out_specs=P(),
        )
        def _action(params, lam):
            F, G, lam0, mu0 = _forcing(
                params, None, lam, 0, n_own, n_own_pad, _offset()
            )
            u, v = _wave_cycle_xla(params, F, G, wh, precision)
            v = v / params.omega
            upd = _scatter_updates(params, lam0, mu0, u, v, n_lambda)
            return lam - jax.lax.psum(upd, axes_)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(self._param_spec, P(axes), P()),
            out_specs=P(),
        )
        def _action_transfer(params, T, lam):
            upd = _transfer_update(
                params, T, lam, n_lambda, n_own, n_own_pad, _offset()
            )
            return lam - jax.lax.psum(upd, axes_)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(self._param_spec, P()),
            out_specs=P(),
        )
        def _rhs(params, f):
            F, G, lam0, mu0 = _forcing(params, f, None, g_ndof)
            u, v = _wave_cycle_xla(params, F, G, wh, precision)
            v = v / params.omega
            upd = _scatter_updates(params, lam0, mu0, u, v, n_lambda)
            return jax.lax.psum(upd, axes_)

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(self._param_spec, P(), P()),
            out_specs=P(),
        )
        def _post(params, lam, f):
            F, G, _, _ = _forcing(params, f, lam, g_ndof, n_own, n_own_pad, _offset())
            u, v = _wave_cycle_xla(params, F, G, wh, precision)
            v = v / params.omega
            y = _scatter_solution(params, u, v, g_ndof)
            return jax.lax.psum(y, axes_)

        if self._roll_data is not None:
            ax1 = axes[0]  # rolled/ppermute exchange is built 1-axis only
            offs_ = self.route_offs
            perms_ = self.route_perms
            perm_fwd = [(i, (i + 1) % n) for i in range(n)]
            perm_bwd = [(i, (i - 1) % n) for i in range(n)]
            pf_ = pf
            n_lost = ddh.n_lambda - n_own

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(
                    self._param_spec,
                    P(axis),
                    P(None, axis),
                    P(axis),
                    P(axis),
                    P(),
                ),
                out_specs=P(),
                check_vma=False,  # replication via all_gather+psum; the
                # static checker can't infer it through ppermute chains
            )
            def _action_rolled(params, A, masks, irr_ls, irr_t, lam):
                """Rolled trace exchange with ppermute halo transfers,
                overlapped with the interior transfer matmul.

                Uniform sender routes shift this device's subdomain block
                locally; only the |off| boundary rows go to the
                neighbouring device.  The boundary rows' (|off|, 2pf) @
                (2pf, 2pf) products are computed FIRST and their ppermutes
                issued before the bulk interior matmul, so XLA's
                latency-hiding scheduler runs the transfer concurrently
                with the interior compute (the reference's design point:
                lambda exchange only at kernel entry/exit,
                DDH.cpp:222-231,310-319).  The small irregular remainder
                scatters into a psum.
                """
                lam0, mu0 = _read_traces(
                    params, lam, n_lambda, n_own, n_own_pad, _offset()
                )
                x = jnp.concatenate([lam0, mu0], axis=1).astype(A.dtype)
                L = x.shape[0]
                # boundary-first: per route, matmul only the rows that cross
                # the shard edge, then start their ppermute
                recvs = []
                for i, (off, _) in enumerate(zip(offs_, perms_)):
                    if off > 0:
                        rows = slice(L - off, L)
                        perm_dir = perm_fwd
                    elif off < 0:
                        rows = slice(0, -off)
                        perm_dir = perm_bwd
                    else:
                        recvs.append(None)
                        continue
                    u2b = jnp.einsum(
                        "dik,dk->di", A[rows], x[rows], precision="highest"
                    )
                    mu_b = masks[i][rows] * jnp.pad(u2b, ((0, 0), (0, 1)))
                    recvs.append(jax.lax.ppermute(mu_b, ax1, perm_dir))
                # interior (full) matmul overlaps the transfers in flight
                u2 = jnp.einsum("dik,dk->di", A, x, precision="highest")
                u2p = jnp.pad(u2, ((0, 0), (0, 1)))  # zero col for dead slots
                out_loc = jnp.zeros_like(u2)
                for i, (off, perm) in enumerate(zip(offs_, perms_)):
                    mu_ = masks[i] * u2p
                    if off > 0:
                        shifted = jnp.concatenate(
                            [recvs[i], mu_[: L - off]], axis=0
                        )
                    elif off < 0:
                        shifted = jnp.concatenate(
                            [mu_[-off:], recvs[i]], axis=0
                        )
                    else:
                        shifted = mu_
                    out_loc = out_loc + shifted[:, np.asarray(perm)]
                full = jax.lax.all_gather(out_loc, ax1, tiled=True)
                out_l = jnp.concatenate(
                    [
                        full[:, :pf_].reshape(-1)[:n_own].astype(lam.dtype),
                        jnp.zeros(n_lost, lam.dtype),
                    ]
                )
                out_m = jnp.concatenate(
                    [
                        full[:, pf_:].reshape(-1)[:n_own].astype(lam.dtype),
                        jnp.zeros(n_lost, lam.dtype),
                    ]
                )
                ls, tg = irr_ls[0], irr_t[0]
                vals_l = u2[:, :pf_].reshape(-1)[ls].astype(lam.dtype)
                vals_m = u2[:, pf_:].reshape(-1)[ls].astype(lam.dtype)
                # one concatenated collective for both halves: half the
                # all-reduce latency of separate addl/addm psums
                add2 = (
                    jnp.zeros((2, n_lambda + 1), lam.dtype)
                    .at[0, tg].add(vals_l, mode="drop", indices_are_sorted=True)
                    .at[1, tg].add(vals_m, mode="drop", indices_are_sorted=True)
                )
                add2 = jax.lax.psum(add2, ax1)
                out_l = out_l + add2[0, :n_lambda]
                out_m = out_m + add2[1, :n_lambda]
                return lam - jnp.concatenate([out_l, out_m])

        # global arrays must be ARGUMENTS of the jitted programs, not
        # closed-over constants: in multi-process runs a closure capturing an
        # array that spans non-addressable devices is rejected
        if self._roll_data is not None:
            A_r, masks_r, irr_ls_r, irr_t_r = self._roll_data
            rolled_jit = jax.jit(_action_rolled)
            self._action_fn = lambda lam: rolled_jit(
                self.params, A_r, masks_r, irr_ls_r, irr_t_r, lam
            )
        elif self.use_transfer:
            transfer_jit = jax.jit(_action_transfer)
            self._action_fn = lambda lam: transfer_jit(self.params, self.T, lam)
        else:
            action_jit = jax.jit(_action)
            self._action_fn = lambda lam: action_jit(self.params, lam)
        rhs_jit = jax.jit(_rhs)
        post_jit = jax.jit(_post)
        self._rhs_fn = lambda f: rhs_jit(self.params, f)
        self._post_fn = lambda lam, f: post_jit(self.params, lam, f)

    def action(self, lam):
        return self._action_fn(lam)

    def rhs(self, f):
        return self._rhs_fn(jnp.asarray(f, self._dtype))

    def postprocess(self, lam, f):
        return self._post_fn(lam, jnp.asarray(f, self._dtype))
