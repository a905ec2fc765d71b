# Copy of pysparselp_tpu/utils/debug.py; assert_all_finite is verbatim,
# debug_mode sets this package's flag instead of JAX's, and check_iterate is
# the trap the solvers run at each chunk boundary while the flag is set.
"""Numerical-sanity debug mode.

The reference's single-threaded design needs no race detection; its sanity
layer is asserts sprinkled through the code (``check_csr_matrix``
``SparseLP.py:86-91``, pyamg level finiteness ``ADMM.py:388-390``,
``CheckDecrease`` ``tools.py:47-59``).  The JAX package traps NaNs with
JAX's ``jax_debug_nans`` / ``jax_debug_infs``, which re-run the jitted
computation op by op and raise at the op that made the value.  PyTorch has
no such switch, so here :func:`debug_mode` sets a package flag and every
device solver checks its iterate and metrics at each chunk boundary
(:func:`check_iterate`, called from ``solvers/base.py::emit_callback`` and
Mehrotra's step loop): the trap fires at the first chunk boundary after the
non-finite value appeared, not at the op that made it.
"""

from __future__ import annotations

import contextlib

import numpy as np

# what the solvers' chunk-boundary check traps; set by debug_mode
_FLAGS = {"nans": False, "infs": False}


@contextlib.contextmanager
def debug_mode(nans=True, infs=False):
    """Trap NaN (and, with ``infs=True``, infinite) iterates in the
    solvers: each device solver checks its iterate and chunk metrics at
    every chunk boundary and raises ``FloatingPointError`` naming the
    solver, the iteration and the value.  Mehrotra checks its iterate and
    its Newton step at each IPM iteration, before a non-finite step is
    rejected and retried with a larger ridge: like JAX's switch, debug mode
    traps such a step although the solver would recover from it.  The
    previous setting is restored on exit.

    Each check reads the device (one synchronisation per value): debug
    only, never in production runs.  With the flag off the check costs no
    device read.
    """
    prev = dict(_FLAGS)
    _FLAGS.update(nans=bool(nans), infs=bool(infs))
    try:
        yield
    finally:
        _FLAGS.update(prev)


def debug_enabled() -> bool:
    """Whether :func:`debug_mode` traps anything (a host read only)."""
    return _FLAGS["nans"] or _FLAGS["infs"]


def check_iterate(solver, niter, **values):
    """Raise ``FloatingPointError`` when :func:`debug_mode` is on and one
    of ``values`` (arrays, tensors or scalars, keyed by name) holds a NaN
    (or an infinity, with ``infs=True``).  A no-op, with no device read,
    when the flag is off."""
    if not debug_enabled():
        return
    import torch

    for name, value in values.items():
        v = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.asarray(value, dtype=np.float64))
        for kind, test in (("nans", torch.isnan), ("infs", torch.isinf)):
            if not _FLAGS[kind]:
                continue
            bad = int(torch.count_nonzero(test(v)))
            if bad:
                raise FloatingPointError(
                    f"{solver}: iteration {int(niter)}: {name} has "
                    f"{bad}/{v.numel()} {'NaN' if kind == 'nans' else 'infinite'}"
                    " entries (debug_mode traps at chunk boundaries)")


def assert_all_finite(name, *arrays):
    """Host-side chunk-boundary check (cheap: state is already fetched)."""
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.all(np.isfinite(a)):
            bad = np.count_nonzero(~np.isfinite(a))
            raise FloatingPointError(
                f"{name}: array {i} has {bad}/{a.size} non-finite entries"
            )
