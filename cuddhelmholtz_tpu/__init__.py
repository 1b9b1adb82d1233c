"""cuddhelmholtz_tpu: a JAX spectral-element Helmholtz framework.

A from-scratch JAX/XLA re-design with the capabilities of the CUDA library
``arotem3/CuDDHelmholtz``: matrix-free 2D spectral-element operators,
restarted GMRES, and the DDH substructured WaveHoltz domain-decomposition
preconditioner, run on an NVIDIA GPU (batched element kernels, precomputed
subdomain transfer matrices, sharded multi-device execution via
``jax.sharding``).

Layer map (mirrors SURVEY.md section 1):
  utils/      quadrature rules, nodal bases           (reference L1-L2 host)
  mesh/       Mesh2D geometry + metric caches          (L2)
  spaces/     H1Space, FaceSpace, EnsembleSpace        (L3)
  ops/        Mass/Stiffness/FaceMass/functionals      (L4)
  solvers/    GMRES(m), DDH preconditioner             (L5)
  models/     Poisson, coupled Helmholtz               (L5/L6)
  parallel/   device-mesh sharding of elements/subdomains
  examples/   drivers reproducing the reference configs (L6)
"""

import os as _os

import jax as _jax

# Process-global x64 policy, decided at import: set CUDDH_X64=1 to enable
# fp64 (the reference's global-system precision) for this process.  The
# package never flips jax_enable_x64 mid-process: arrays and programs made
# before the flip would silently keep the old dtypes.  Drivers asked for
# float64 without x64 raise instead (docs/DTYPES.md).
if _os.environ.get("CUDDH_X64", "") not in ("", "0", "false"):
    _jax.config.update("jax_enable_x64", True)

# The reference's global operators are true fp64/fp32 (SURVEY.md section 1,
# "precision split").  On the GPU an fp32 matmul at the "default" word may
# run on TF32 tensor cores (10-bit mantissa), which stalls GMRES well above
# the reference tolerances.  Default every matmul/einsum/dot to true fp32;
# every hot-path site also names its precision explicitly (docs/DTYPES.md).
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache.  A user-set JAX_COMPILATION_CACHE_DIR (or a
# cache dir already set in jax's config) is honoured and no other directory
# is set in code.  Otherwise the cache lives at the fixed, gitignored
# <checkout>/.jax_cache: the path is part of what makes repeat runs from one
# checkout hit it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    if not _jax.config.jax_compilation_cache_dir:
        _jax.config.update(
            "jax_compilation_cache_dir",
            _os.path.join(_os.path.dirname(_os.path.dirname(
                _os.path.abspath(__file__))), ".jax_cache"),
        )
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

from .mesh.io import load_mesh_dir, load_unstructured_square, to_file
from .mesh.mesh2d import Mesh2D
from .solvers.ddh import DDH
from .solvers.gmres import gmres
from .solvers.implicit import implicit_solve
from .spaces.ensemble import EnsembleSpace
from .spaces.h1 import FaceSpace, H1Space
from .utils.basis import Basis
from .utils.quadrature import QuadratureRule

__version__ = "0.1.0"

__all__ = [
    "Basis",
    "DDH",
    "EnsembleSpace",
    "FaceSpace",
    "H1Space",
    "Mesh2D",
    "QuadratureRule",
    "gmres",
    "implicit_solve",
    "load_mesh_dir",
    "load_unstructured_square",
    "to_file",
]
