"""pysparselp_tpu_torch — the PyTorch + CUDA port of pysparselp_tpu.

Models sparse LPs

    min cᵀx   s.t.   A_e x = b_e,   b_lower ≤ A_i x ≤ b_upper,   l ≤ x ≤ u

with the same host modeling layer as the JAX package and solves them with
PyTorch on an NVIDIA GPU, where the hot loops run hand-written Hopper
kernels (``csrc/``).  Ported so far: ``SparseLP.solve(method=
"chambolle_pock_ppd")``.  The package imports ``torch`` and never ``jax``.
"""

from .modeling import SparseLP, solving_methods
from .sparse_host import BlockedCSR, crd_matrix

__all__ = ["SparseLP", "solving_methods", "BlockedCSR", "crd_matrix"]

__version__ = "0.1.0"
