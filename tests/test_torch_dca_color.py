"""H-DCA-C, the colour sweep of blocked dual coordinate ascent
(``ops/dca_sweep.py``: ``ColorPlan``, ``dca_color_sweep`` and its twin
``dca_color_sweep_reference``): the plan's properties, the twin against
the per-group twin loop and the JAX package's ``_dca_color_sweep``
(``pysparselp_tpu/solvers/dual_ascent.py``) compiled, in float32 and
float64, bit for bit with the returned key; and, marked ``cuda``, the
one-launch kernel against the twin on the card, bit for bit, with a NaN
cost and signed zeros, and the one-group entry with ``tie_offset``.

This module imports no jax at import time: its ``cuda`` cases run on a
machine without JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import dca_sweep as pdca
from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows
from pysparselp_tpu_torch.utils.jax_prng import prng_key, split
from test_torch_dca_sweep import CASES, DTYPES, _bits, _jax_sweep, _state
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)


def _plan(host, d):
    groups = _color_rows(host["a"])
    return groups, pdca.ColorPlan.build(d["ell"], groups, d["b"], d["lb"],
                                        d["ub"])


def _args(d, plan, key, project):
    return (d["ell"], plan, d["b"], d["active"], d["y"], d["c_bar"], d["lb"],
            d["ub"], key, project)


@pytest.mark.parametrize("case", ["potts20", "matching", "integer",
                                  "integer6", "integer12"])
def test_color_plan_properties(case):
    """Every row once, group by group in the colouring's order; a group's
    rows share no stored column; the staged rows (rows of up to SCAN_BASE
    slots) are the rows' gathers in that order, slot-major."""
    host, d = _state(case, torch.float64)
    groups, plan = _plan(host, d)
    order, ptr = plan.order.numpy(), plan.ptr.numpy()
    m, k = d["ell"].vals.shape
    assert np.array_equal(np.sort(order), np.arange(m))
    assert np.array_equal(np.diff(ptr), [len(g) for g in groups])
    assert plan.max_rows == max(len(g) for g in groups)
    csr = host["a"].tocsr()
    for g, rows in zip(groups, plan.groups):
        assert np.array_equal(rows.numpy(), g)
        used = csr[g].indices
        assert np.unique(used).size == used.size
    if k > pdca.SCAN_BASE:
        assert plan.staged is None
        return
    st, o = plan.staged, torch.as_tensor(order).long()
    assert torch.equal(st["vals"], d["ell"].vals[o].T)
    assert torch.equal(st["cols"], d["ell"].cols[o].T)
    cl = d["ell"].cols[o].T.long()
    assert torch.equal(st["lb"], d["lb"][cl])
    assert torch.equal(st["ub"], d["ub"][cl])
    assert torch.equal(st["b"], d["b"][o])
    # int32 order and offsets; float64 values and bounds, int32 columns, b
    assert pdca.color_plan_bytes(plan) == 4 * m + 4 * (len(groups) + 1) + (
        m * k * (8 * 3 + 4) + 8 * m)


# the integer rows of up to 40 entries have many colours, which make JAX's
# compiled sweep slow to build (~15 s a case): rows of up to 6 instead,
# float64 only
JAX_CASES = [("potts20", "float32"), ("potts20", "float64"),
             ("matching", "float32"), ("matching", "float64"),
             ("integer6", "float64")]


@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case,dtype", JAX_CASES)
def test_color_sweep_twin_matches_jax(case, dtype, project):
    """The one-call twin equals the per-group twin loop and JAX's compiled
    colour sweep bit for bit (y, c̄ as integers, and the key), float32
    and float64; on the CPU ``dca_color_sweep`` is the twin."""
    npdt, tdt = DTYPES[dtype]
    host, d = _state(case, tdt)
    groups, plan = _plan(host, d)
    key = prng_key(5)
    got = pdca.dca_color_sweep_reference(*_args(d, plan, key, project))
    y, c_bar = d["y"], d["c_bar"]
    for rows in groups:
        key, sub = split(key)
        y, c_bar = pdca.dca_color_step_reference(
            d["ell"], d["b"], d["active"], y, c_bar, d["lb"], d["ub"],
            torch.as_tensor(rows), sub, project)
    assert torch.equal(_bits(got[0]), _bits(y))
    assert torch.equal(_bits(got[1]), _bits(c_bar))
    assert got[2] == key
    wy, wc, wkey = _jax_sweep(host, npdt, prng_key(5), project, groups)
    np.testing.assert_array_equal(_bits(got[0]).numpy(),
                                  _bits(torch.as_tensor(wy)).numpy())
    np.testing.assert_array_equal(_bits(got[1]).numpy(),
                                  _bits(torch.as_tensor(wc)).numpy())
    assert got[2] == tuple(int(v) for v in wkey)
    cpu = pdca.dca_color_sweep(*_args(d, plan, prng_key(5), project))
    assert torch.equal(_bits(cpu[1]), _bits(got[1])) and cpu[2] == got[2]


def _zero_cases(dtype, device):
    """Rows of up to 6 entries that never touch column 0 (so padding alone
    writes it), c̄[0] = -0, a NaN cost at column 5, signed zeros in c̄ and
    y, a third of the rows inactive (their step +0): the padding's +0
    turns c̄[0] to +0, and the NaN column stays NaN."""
    a, b, c, lb, ub = CASES["integer6"]()
    a = scipy.sparse.csr_matrix(a)
    a = scipy.sparse.csr_matrix(
        (a.data, np.maximum(a.indices, 1), a.indptr), shape=a.shape)
    a.sum_duplicates()
    rng = np.random.RandomState(8)
    m, n = a.shape
    y = np.where(rng.rand(m) < 0.5, -0.0, rng.rand(m))
    c_bar = c + a.T @ np.abs(y)
    c_bar[0] = -0.0
    c_bar[5] = np.nan
    c_bar[rng.rand(n) < 0.1] = -0.0
    active = rng.rand(m) < 0.66
    host = dict(a=a, b=b, lb=lb, ub=ub, y=y, c_bar=c_bar, active=active)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    dev = dict(ell=pdca.EllRows.from_scipy(a, dtype, device), b=t(b),
               lb=t(lb), ub=t(ub), y=t(y), c_bar=t(c_bar),
               active=torch.as_tensor(active, device=device))
    return host, dev


def _same(got, want):
    """Bit for bit, a NaN as a NaN (the card's arithmetic gives its own NaN
    bits)."""
    for g, w in zip(got, want):
        nan = torch.isnan(w)
        if not (torch.equal(torch.isnan(g), nan)
                and torch.equal(_bits(g)[~nan], _bits(w)[~nan])):
            return False
    return True


@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
def test_color_sweep_twin_signed_zeros_match_jax(project):
    """The NaN and signed-zero state: the twin's padding turns c̄[0] from
    -0 to +0 and keeps the NaN, as JAX's compiled sweep does."""
    host, d = _zero_cases(torch.float64, "cpu")
    groups, plan = _plan(host, d)
    got = pdca.dca_color_sweep_reference(*_args(d, plan, prng_key(6),
                                                project))
    wy, wc, wkey = _jax_sweep(host, np.float64, prng_key(6), project, groups)
    assert _same(got[:2], (torch.as_tensor(wy), torch.as_tensor(wc)))
    assert got[2] == tuple(int(v) for v in wkey)
    assert float(got[1][0]) == 0.0 and not torch.signbit(got[1][0])
    assert torch.isnan(got[1][5])


# ----------------------------------------------------------------------
# on the card: the one-launch kernel against the twin
# ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case", ["potts20", "matching", "integer",
                                  "integer6", "integer12", "long", "wide"])
def test_kernel_color_sweep_matches_twin(case, project, dtype):
    """One launch for the whole sweep, bit for bit with the twin (y, c̄
    and the key): a thread a row of up to 16 slots (potts20, integer6,
    integer12, wide), a warp a longer row (matching, integer, long)."""
    dev = cuda_or_skip()
    _npdt, tdt = DTYPES[dtype]
    host, d = _state(case, tdt, device=dev)
    _groups, plan = _plan(host, d)
    args = _args(d, plan, prng_key(7), project)
    before = pdca.dca_color_sweep.launches
    got = pdca.dca_color_sweep(*args)
    assert pdca.dca_color_sweep.launches == before + 1
    want = pdca.dca_color_sweep_reference(*args)
    assert _same(got[:2], want[:2]) and got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
def test_kernel_color_sweep_keeps_nan_and_signed_zeros(project, dtype):
    """The NaN and signed-zero state through the one-launch sweep and
    through the one-group entry on halves of each group with their
    ``tie_offset``: both equal the twin, c̄[0] turned to +0."""
    dev = cuda_or_skip()
    host, d = _zero_cases(DTYPES[dtype][1], dev)
    _groups, plan = _plan(host, d)
    args = _args(d, plan, prng_key(6), project)
    got = pdca.dca_color_sweep(*args)
    want = pdca.dca_color_sweep_reference(*args)
    assert _same(got[:2], want[:2]) and got[2] == want[2]
    assert not torch.signbit(got[1][0])
    key = prng_key(6)
    y, c_bar = d["y"], d["c_bar"]
    wy, wc = y, c_bar
    for rows in plan.groups:
        key, sub = split(key)
        half = (rows.numel() + 1) // 2
        for lo, hi in ((0, half), (half, rows.numel())):
            y, c_bar = pdca.dca_color_step(
                d["ell"], d["b"], d["active"], y, c_bar, d["lb"], d["ub"],
                rows[lo:hi], sub, project, tie_offset=lo)
            wy, wc = pdca.dca_color_step_reference(
                d["ell"], d["b"], d["active"], wy, wc, d["lb"], d["ub"],
                rows[lo:hi], sub, project, tie_offset=lo)
            assert _same((y, c_bar), (wy, wc))
    assert _same((y, c_bar), got[:2])
