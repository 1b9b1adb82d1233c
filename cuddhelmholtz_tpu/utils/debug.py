"""Opt-in debug validation (the ``CUDDH_DEBUG`` analog).

The reference's debug build enables index bounds checks in every tensor
access and in-kernel asserts (``/root/reference/include/Tensor.hpp:34-37``,
``source/DDH.cpp:162-164``).  This package's device ops mask out-of-range
indices (``mode="drop"/"fill"``), which is correct for the -1 padding
convention but silently produces wrong numbers if an index TABLE is
corrupted.  Setting ``CUDDH_DEBUG=1`` turns on:

  * setup-time audits of every index table (entries must be -1 padding or
    in-range) — ``H1Space``, ``EnsembleSpace``, and ``DDH`` run them in
    their constructors;
  * host-side finiteness checks on solver entry/exit values via
    ``check_finite`` (inside jitted loops values are traced, so checks run
    at the public API boundary).

The flag is read per call, so tests can toggle it with ``monkeypatch``.
"""

from __future__ import annotations

import os

import numpy as np


def debug_enabled() -> bool:
    v = os.environ.get("CUDDH_DEBUG", "")
    return v not in ("", "0", "false", "False")


def check_index_table(
    name: str, table, size: int, allow_pad: bool = True
) -> None:
    """Audit an index table: every entry in [0, size), or -1 padding.

    No-op unless ``CUDDH_DEBUG`` is set.  Raises ``ValueError`` naming the
    first offending entry (the reference's cuddh_error analog,
    ``cuddh_error.cpp:5-9``).
    """
    if not debug_enabled():
        return
    arr = np.asarray(table)
    lo = -1 if allow_pad else 0
    bad = (arr < lo) | (arr >= size)
    if bad.any():
        idx = np.unravel_index(int(np.argmax(bad)), arr.shape)
        raise ValueError(
            f"CUDDH_DEBUG: index table '{name}' entry {idx} = "
            f"{int(arr[idx])} outside [{lo}, {size})"
        )


def check_finite(name: str, x) -> None:
    """Raise ``FloatingPointError`` if ``x`` contains NaN/Inf (host-side;
    materialises the array).  No-op unless ``CUDDH_DEBUG`` is set."""
    if not debug_enabled():
        return
    arr = np.asarray(x)
    if not np.isfinite(arr).all():
        n_bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(
            f"CUDDH_DEBUG: '{name}' contains {n_bad} non-finite entries"
        )
