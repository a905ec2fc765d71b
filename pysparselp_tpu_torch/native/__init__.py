# Copy of pysparselp_tpu/native/__init__.py; the docstring names this
# package's modules (tests/test_torch_gauss_seidel.py holds the exports equal).
"""Host-side native (C++) kernels: sequential algorithms kept off-device.

Two algorithm families in the framework are irreducibly sequential and run
as compiled C++ on the host, mirroring the reference's native surface
(its two Cython extensions — SURVEY.md §2):

* bounded Gauss-Seidel / SOR sweeps (:mod:`.gauss_seidel`), and
* interval constraint propagation with backtracking
  (:mod:`pysparselp_tpu_torch.integer.propagation`).

Each compiles on first use with ``g++`` into the repository's
``build/pysparselp_tpu_torch/`` and loads through ctypes, with a
pure-numpy fallback when no toolchain is available.
"""

from .gauss_seidel import BoundedGaussSeidel, gauss_seidel

__all__ = ["gauss_seidel", "BoundedGaussSeidel"]
