"""pysparselp_tpu_torch — the PyTorch + CUDA port of pysparselp_tpu.

Models sparse LPs

    min cᵀx   s.t.   A_e x = b_e,   b_lower ≤ A_i x ≤ b_upper,   l ≤ x ≤ u

with the same host modeling layer as the JAX package and solves them with
PyTorch on an NVIDIA GPU, where the hot loops run hand-written Hopper
kernels (``csrc/``).  Ported: every method of ``SparseLP.solve`` —
``chambolle_pock_ppd``, ``mehrotra``, ``admm`` (also
``inner="gauss_seidel"``, a host mode), ``admm2``, ``admm_blocks``,
``dual_gradient_ascent`` and ``dual_coordinate_ascent``, on one device or,
with ``mesh=``, over the ranks of a ``torch.distributed`` group
(:mod:`.parallel`); the host bridges
``scipy_simplex`` / ``scipy_interior_point`` and, where their packages are
installed, ``osqp`` and cvxpy's ``ECOS`` / ``SCS`` / ``CVXOPT`` — batched
serving (:func:`solve_cp_batch`), checkpoints (:func:`save_checkpoint`,
:func:`load_checkpoint`, :class:`CheckpointingCallback`; the ``.npz``
format is the JAX package's), the instrumentation of :mod:`.utils`
(``profile_trace`` on ``torch.profiler``, ``debug_mode``), the benchmark
driver :mod:`.benchmarks`, I/O (MPS, netlib, LPsparse text) and the
examples.  The package imports ``torch`` and never ``jax``.
"""

from .batch import solve_cp_batch
from .checkpoint import (
    CheckpointingCallback,
    load_checkpoint,
    save_checkpoint,
)
from .modeling import SparseLP, solving_methods
from .sparse_host import BlockedCSR, crd_matrix

__all__ = [
    "SparseLP",
    "solving_methods",
    "BlockedCSR",
    "crd_matrix",
    "save_checkpoint",
    "load_checkpoint",
    "CheckpointingCallback",
    "solve_cp_batch",
]

__version__ = "0.1.0"
