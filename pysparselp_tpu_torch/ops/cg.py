"""Conjugate-gradient linear solver (device-side, matrix-free), PyTorch port
of ``pysparselp_tpu/ops/cg.py``.

The JAX ``conjgrad`` is a ``lax.while_loop`` whose condition reads the
residual norm on the device.  A Python loop that read it back every step
would synchronise the card once per CG step (Mehrotra runs up to ten CG
solves of up to 200 steps per interior-point iteration).  Here the stopping
test stays on the device as a 0-d flag, ``active = ‖r‖ > tol·‖b‖``: every
update of a step is taken under ``torch.where(active, new, old)`` (never a
multiplication by a mask, since NaN times zero is NaN), so a step past the
exit changes nothing, and the host reads the flag only every
:data:`CHECK_EVERY` steps to leave the loop.  The result is the JAX loop's
at the same exit step.
"""

from __future__ import annotations

import torch

# steps between two host reads of the device stopping flag
CHECK_EVERY = 16


def _nonzero(v):
    """``v`` with 0 replaced by 1 (the JAX loop's zero-denominator guard)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def conjgrad(matvec, b, x0=None, maxiter=100, tol=1e-10, precond=None,
             dot=None):
    """Preconditioned conjugate gradient for SPD ``A x = b``.

    Args:
      matvec: function computing ``A @ v``.
      b: right-hand side.
      x0: initial guess (zeros if None).
      maxiter: iteration cap; the loop leaves earlier once
        ``‖r‖ ≤ tol·max(‖b‖, 1e-300)`` (``1e-300`` is 0 in float32, as in
        the JAX loop).
      tol: relative residual tolerance.
      precond: optional function computing ``M⁻¹ v``.
      dot: the inner product of two vectors (``torch.dot`` when None);
        a mesh solve over row-sharded vectors passes one that reduces
        over the ranks, and the norms are then ``sqrt(dot(v, v))``.

    Returns the solution estimate.  ``conjgrad.calls``, ``conjgrad.steps``
    and ``conjgrad.syncs`` count the solves, the steps they ran (a step
    past the exit, at most ``CHECK_EVERY - 1`` per solve, included) and
    the host reads of the stopping flag.
    """
    if dot is None:
        dot, norm = torch.dot, torch.linalg.norm
    else:
        def norm(v):
            return torch.sqrt(dot(v, v))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r) if precond is not None else r
    p = z
    rz = dot(r, z)
    thresh = tol * torch.clamp_min(norm(b), 1e-300)
    active = norm(r) > thresh
    conjgrad.calls += 1
    for k in range(int(maxiter)):
        if k % CHECK_EVERY == 0:
            conjgrad.syncs += 1
            if not bool(active):
                break
        ap = matvec(p)
        alpha = rz / _nonzero(dot(p, ap))
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * ap
        z_new = precond(r_new) if precond is not None else r_new
        rz_new = dot(r_new, z_new)
        p = torch.where(active, z_new + rz_new / _nonzero(rz) * p, p)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
        active = active & (norm(r) > thresh)
        conjgrad.steps += 1
    return x


conjgrad.calls = 0
conjgrad.steps = 0
conjgrad.syncs = 0
