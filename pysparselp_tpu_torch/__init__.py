"""pysparselp_tpu_torch — the PyTorch + CUDA port of pysparselp_tpu.

Models sparse LPs

    min cᵀx   s.t.   A_e x = b_e,   b_lower ≤ A_i x ≤ b_upper,   l ≤ x ≤ u

with the same host modeling layer as the JAX package and solves them with
PyTorch on an NVIDIA GPU, where the hot loops run hand-written Hopper
kernels (``csrc/``).  Ported so far: ``SparseLP.solve(method=
"chambolle_pock_ppd")`` (one device, or row-sharded with ``mesh=``), the
host bridges ``method="scipy_simplex"`` / ``"scipy_interior_point"``, and
batched serving, :func:`solve_cp_batch`.  The package imports ``torch`` and
never ``jax``.
"""

from .batch import solve_cp_batch
from .modeling import SparseLP, solving_methods
from .sparse_host import BlockedCSR, crd_matrix

__all__ = ["SparseLP", "solving_methods", "BlockedCSR", "crd_matrix",
           "solve_cp_batch"]

__version__ = "0.1.0"
