"""1D quadrature rules on [-1, 1] (host-side setup, float64).

Capability parity with the reference's ``QuadratureRule``
(``/root/reference/include/QuadratureRule.hpp``,
``/root/reference/source/QuadratureRule.cpp``): Gauss-Legendre and
Gauss-Lobatto rules of any order, built with the Golub-Welsch algorithm
(symmetric-tridiagonal eigenvalues) followed by a few Newton refinement steps
on the appropriate Jacobi polynomial, with closed-form weights.

This package keeps all of this on the host in NumPy: quadrature data are
tiny static arrays that get baked into jitted operator closures.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .jacobi import jacobi_p, jacobi_p_derivative

_NEWTON_STEPS = 3


def _symmetrize(x: np.ndarray) -> np.ndarray:
    """Enforce exact symmetry of a node set about the origin."""
    n = x.size
    half = n // 2
    x = x.copy()
    x[: half] = 0.5 * (x[:half] - x[::-1][:half])
    x[n - half:] = -x[:half][::-1]
    if n % 2 == 1:
        x[half] = 0.0
    return x


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule: exact for polynomials of degree 2n-1."""
    if n < 1:
        raise ValueError(f"Gauss-Legendre rules require n >= 1, got n={n}")
    if n == 1:
        x = np.zeros(1)
    else:
        k = np.arange(1, n, dtype=np.float64)
        off = k / np.sqrt(4.0 * k * k - 1.0)
        x = scipy.linalg.eigvalsh_tridiagonal(np.zeros(n), off)
        # Newton-refine the eigenvalue estimates on P_n (Legendre).
        for _ in range(_NEWTON_STEPS):
            x = x - jacobi_p(n, 0.0, 0.0, x) / jacobi_p_derivative(1, n, 0.0, 0.0, x)
        x = _symmetrize(np.sort(x))
    dp = jacobi_p_derivative(1, n, 0.0, 0.0, x)
    w = 2.0 / ((1.0 - x * x) * dp * dp)
    return x, w


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Lobatto rule (includes +-1): exact for degree 2n-3."""
    if n < 2:
        raise ValueError(f"Gauss-Lobatto rules require n >= 2, got n={n}")
    if n == 2:
        interior = np.zeros(0)
    else:
        m = n - 2  # interior nodes are roots of P^{(1,1)}_{n-2}
        if m == 1:
            interior = np.zeros(1)
        else:
            k = np.arange(1, m, dtype=np.float64)
            off = np.sqrt(k * (k + 2.0) / ((2.0 * k + 3.0) * (2.0 * k + 1.0)))
            interior = scipy.linalg.eigvalsh_tridiagonal(np.zeros(m), off)
        for _ in range(_NEWTON_STEPS):
            interior = interior - jacobi_p(m, 1.0, 1.0, interior) / jacobi_p_derivative(
                1, m, 1.0, 1.0, interior
            )
        interior = _symmetrize(np.sort(interior))
    x = np.concatenate(([-1.0], interior, [1.0]))
    pn1 = jacobi_p(n - 1, 0.0, 0.0, x)
    w = 2.0 / (n * (n - 1) * pn1 * pn1)
    return x, w


class QuadratureRule:
    """Immutable quadrature rule: nodes ``x`` and weights ``w`` on [-1, 1]."""

    GaussLegendre = "legendre"
    GaussLobatto = "lobatto"

    def __init__(self, n: int, kind: str = GaussLobatto):
        if kind not in (self.GaussLegendre, self.GaussLobatto):
            raise ValueError(f"unknown quadrature kind: {kind!r}")
        self.n = int(n)
        self.kind = kind
        if kind == self.GaussLegendre:
            self.x, self.w = gauss_legendre(self.n)
        else:
            self.x, self.w = gauss_lobatto(self.n)
        self.x.setflags(write=False)
        self.w.setflags(write=False)

    @property
    def name(self) -> str:
        """Stable cache key (mirrors reference ``QuadratureRule::name``)."""
        return f"{self.kind}{self.n:05d}"

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"QuadratureRule(n={self.n}, kind={self.kind!r})"
