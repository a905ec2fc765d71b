"""Exact line search for LP dual ascent, as sort + cumsum (mirrors
``pysparselp_tpu/ops/linesearch.py:19``).

The dual of a box-constrained LP along a ray ``y + α g`` is a piecewise-linear
concave function of α; its breakpoints are where a reduced cost
``c̄_k + α (gᵀA)_k`` changes sign.  :func:`exact_dual_line_search` finds the
maximizer by sorting the breakpoints and accumulating derivative pieces,
along the last axis of its inputs (a batch of rows searched at once is a
leading axis).

Every step rounds as the JAX function does on the CPU, so that the exact
comparisons downstream (``derivs == 0``, the sign of a derivative) decide
alike:

* the sort is stable, with ``-0.0`` and ``0.0`` equal and NaN last
  (``jnp.argsort``);
* :func:`xla_cumsum` adds in the order XLA's CPU backend does, which cuts
  a scan longer than 16 into rows of 16 (``ReduceWindowRewriter``);
* :func:`_searchsorted_left` is ``jnp.searchsorted``'s default binary
  search, step for step (its result on an array that rounding left out of
  order is the JAX one);
* the clip of ``k`` to ``[1, n]`` and the tie rule are JAX's, the tie's
  interpolation a fused multiply-add as XLA's CPU backend contracts it.
"""

from __future__ import annotations

import math

import torch

# XLA's CPU backend rewrites a cumulative sum longer than this into rows of
# this length (the base length of its ReduceWindowRewriter)
SCAN_BASE = 16


def _sequential_scan(x):
    """Inclusive sums along the last axis, one addition after the other
    (``torch.cumsum`` does exactly that for float64 on the CPU; float32
    there accumulates in float64, and CUDA scans in parallel)."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return torch.cumsum(x, dim=-1)
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, dim=-1)


def xla_cumsum(x):
    """``jnp.cumsum`` along the last axis, rounded as XLA's CPU backend
    rounds it: up to ``SCAN_BASE`` entries in order; longer, padded with
    zeros to rows of ``SCAN_BASE``, each row in order, plus the exclusive
    scan (by this rule) of the rows' totals."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _sequential_scan(x) if n else x.clone()
    nrow = -(-n // SCAN_BASE)
    pad = x.new_zeros(x.shape[:-1] + (nrow * SCAN_BASE - n,))
    rows = torch.cat([x, pad], dim=-1).reshape(
        x.shape[:-1] + (nrow, SCAN_BASE))
    within = _sequential_scan(rows)
    before = xla_cumsum(within[..., -1])
    excl = torch.cat([before.new_zeros(before.shape[:-1] + (1,)),
                      before[..., :-1]], dim=-1)
    out = within + excl[..., None]
    return out.reshape(x.shape[:-1] + (nrow * SCAN_BASE,))[..., :n]


def _searchsorted_left(neg_derivs):
    """``jnp.searchsorted(neg_derivs, 0.0)`` along the last axis: the fixed
    ``ceil(log2(L + 1))`` halvings of ``[0, L]``, going left where
    ``0.0 <= v`` in JAX's sort order (zeros equal, NaN largest)."""
    length = neg_derivs.shape[-1]
    lead = neg_derivs.shape[:-1]
    low = torch.zeros(lead + (1,), dtype=torch.int64,
                      device=neg_derivs.device)
    high = torch.full_like(low, length)
    for _ in range(int(math.ceil(math.log2(length + 1)))):
        mid = (low + high) // 2
        v = torch.gather(neg_derivs, -1, mid)
        go_left = (v >= 0) | torch.isnan(v)
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                 high)
    return high


def exact_dual_line_search(da, db, c_bar, upper_bounds, lower_bounds,
                           tie_t=0.5):
    """Maximizing step α* of the LP dual along a direction, per row of the
    last axis.

    Args:
      da: ``gᵀA``, the change of the reduced costs per unit step (zero
        entries are masked out); shape ``(..., n)``.
      db: ``gᵀb``, the change of the linear dual term; shape ``(...)`` or
        a scalar.
      c_bar: the current reduced costs, shaped as ``da``.
      upper_bounds / lower_bounds: the variables' bounds (may be ±inf),
        shaped as ``da``.
      tie_t: the interpolation used where the derivative is exactly 0 on a
        breakpoint interval (a uniform draw), shape ``(...)`` or a scalar.

    Returns α* of shape ``(...)`` (+inf where the dual is unbounded along
    the ray; callers clamp it).
    """
    n = da.shape[-1]
    mask = da != 0
    alphas = torch.where(mask, -c_bar / torch.where(mask, da, 1.0),
                         torch.inf)
    dau = torch.where(mask, da * upper_bounds, 0.0)
    dal = torch.where(mask, da * lower_bounds, 0.0)
    lo = torch.minimum(dau, dal)
    hi = torch.maximum(dau, dal)

    alphas_s, order = torch.sort(alphas, dim=-1, stable=True)
    lo_s = torch.gather(lo, -1, order)
    hi_s = torch.gather(hi, -1, order)

    # derivative of the dual on each of the n + 1 breakpoint intervals:
    # derivs[j] = -db + sum_{k >= j} hi_s[k] + sum_{k < j} lo_s[k]
    zero = da.new_zeros(da.shape[:-1] + (1,))
    suffix_hi = torch.cat([xla_cumsum(hi_s.flip(-1)).flip(-1), zero], -1)
    prefix_lo = torch.cat([zero, xla_cumsum(lo_s)], -1)
    db = torch.as_tensor(db, dtype=da.dtype, device=da.device)
    derivs = (-db)[..., None] + suffix_hi + prefix_lo

    # concave => derivs non-increasing; first interval with deriv <= 0
    k = torch.clamp(_searchsorted_left(-derivs), 1, n)
    alpha_lo = torch.gather(alphas_s, -1, k - 1)[..., 0]
    alpha_hi = torch.gather(alphas_s, -1, torch.clamp_max(k, n - 1))[..., 0]
    tie = ((torch.gather(derivs, -1, k)[..., 0] == 0) & (k[..., 0] < n)
           & torch.isfinite(alpha_hi))
    # JAX on the CPU contracts this into fma(t, α_hi, (1 - t) α_lo);
    # torch.addcmul is that fused multiply-add (on the CPU and on CUDA), as
    # is H-DCA's explicit fma
    tie_t = torch.as_tensor(tie_t, dtype=da.dtype, device=da.device)
    mixed = torch.addcmul((1.0 - tie_t) * alpha_lo, tie_t, alpha_hi)
    return torch.where(tie, mixed, alpha_lo)
