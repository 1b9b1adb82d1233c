"""BLAS-1 style vector operations (reference L1 parity).

Parity with ``/root/reference/include/linalg.hpp`` (axpby, dot, norm, dist,
copy, scal, fill, zeros, ones).  Here these are trivial fused XLA
expressions rather than hand-written reduction kernels (the reference uses a
tree-reduce + atomicAdd CUDA kernel for ``dot``, ``linalg.cpp:6-47``); they
exist as named functions so solver code reads like the reference and so the
sharded variants (psum reductions) have one place to hook: ``solvers/gmres``
routes every Arnoldi/residual norm through :func:`norm`.

All functions are pure: "in-place" reference semantics (y <- a x + b y)
become return values.
"""

from __future__ import annotations

import jax.numpy as jnp


def axpby(a, x, b, y):
    """a * x + b * y."""
    return a * x + b * y


def dot(x, y):
    """Sum of elementwise products (psum-reduced when sharded)."""
    return jnp.vdot(x, y)


def norm(x):
    return jnp.linalg.norm(x)


def dist(x, y):
    """||x - y||_2."""
    return jnp.linalg.norm(x - y)


def copy(x):
    return jnp.asarray(x).copy()


def scal(a, x):
    return a * x


def fill(n, value, dtype=jnp.float64):
    return jnp.full(n, value, dtype=dtype)


def zeros(n, dtype=jnp.float64):
    return jnp.zeros(n, dtype=dtype)


def ones(n, dtype=jnp.float64):
    return jnp.ones(n, dtype=dtype)
