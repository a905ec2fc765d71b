"""H-DCA's plain twins (``ops/dca_sweep.py``) against the JAX package's
coordinate sweeps (``_dca_sweep_eq``, ``_dca_sweep_ineq``,
``_dca_color_sweep`` of ``pysparselp_tpu/solvers/dual_ascent.py``) on the
same rows, state and key, on the CPU; the level schedule's properties
and the level-by-level twin, bit-equal to the sequential one; and, marked
``cuda``, the kernel against the twin on the card, bit for bit (y, c̄ and
the key), in float32 and float64, with the over-limit row refused.

This module imports no jax at import time: its ``cuda`` cases run on a
machine without JAX (``python -m pytest --noconftest -m cuda``)."""

import copy

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops import dca_sweep as pdca
from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows
from pysparselp_tpu_torch.utils.convert import key_from_jax
from pysparselp_tpu_torch.utils.jax_prng import prng_key, split, uniform
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _potts_rows(size=20):
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp = build_linear_program(size, 0.5, 500, seed=1)[0]
    lp.convert_to_one_sided_inequality_system()
    return (lp.a_inequalities.tocsr(), lp.b_upper, lp.costsvector,
            lp.lower_bounds, lp.upper_bounds)


def _sc105_rows():
    from torch_port_helpers import sc105_lp

    lp = sc105_lp(port=True)[0]
    return (lp.a_inequalities.tocsr(), lp.b_upper, lp.costsvector,
            lp.lower_bounds, lp.upper_bounds)


def _matching_rows():
    from pysparselp_tpu_torch.examples.bipartite_matching import \
        add_bipartite_constraint
    from pysparselp_tpu_torch.modeling import SparseLP

    rng = np.random.RandomState(2)
    cost = -rng.rand(50, 50)
    lp = SparseLP()
    idx = lp.add_variables_array(cost.shape, 0, 1, cost)
    add_bipartite_constraint(lp, idx)
    lp.convert_to_one_sided_inequality_system()
    return (lp.a_inequalities.tocsr(), lp.b_upper, lp.costsvector,
            lp.lower_bounds, lp.upper_bounds)


def _integer_rows(m=60, n=80, k=40, seed=4):
    """Random integer rows of up to ``k`` entries (many ties), some short
    rows whose padding the search lands in."""
    rng = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for i in range(m):
        w = rng.randint(1, k + 1)
        c = rng.choice(n, w, replace=False)
        rows += [i] * w
        cols += list(c)
        vals += list(rng.choice([-2.0, -1.0, 1.0, 2.0], w))
    a = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(m, n))
    return (a, rng.randint(-3, 4, m).astype(float),
            rng.randint(-3, 4, n).astype(float), np.zeros(n),
            np.where(rng.rand(n) < 0.2, np.inf, 1.0))


CASES = {"potts20": _potts_rows, "sc105": _sc105_rows,
         "matching": _matching_rows, "integer": _integer_rows,
         "integer6": lambda: _integer_rows(k=6, seed=6),
         "integer12": lambda: _integer_rows(k=12, seed=7)}


def _state(case, dtype, device="cpu", seed=0):
    """Rows, b, a random ``active`` mask, y >= 0 and c̄ for a case (numpy
    float64 arrays, then tensors of ``dtype``)."""
    a, b, c, lb, ub = CASES[case]()
    rng = np.random.RandomState(seed)
    m = a.shape[0]
    y = np.where(rng.rand(m) < 0.5, 0.0, rng.rand(m))
    c_bar = c + a.T @ y
    active = rng.rand(m) < 0.8
    host = dict(a=a, b=b, lb=lb, ub=ub, y=y, c_bar=c_bar, active=active)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    dev = dict(ell=pdca.EllRows.from_scipy(a, dtype, device), b=t(b),
               lb=t(lb), ub=t(ub), y=t(y), c_bar=t(c_bar),
               active=torch.as_tensor(active, device=device))
    return host, dev


def _jax_sweep(host, npdt, key, project, groups=None):
    import jax
    import jax.numpy as jnp

    from pysparselp_tpu.problem import EllMatrix
    from pysparselp_tpu.solvers import dual_ascent as jda

    ell = EllMatrix.from_scipy(host["a"], dtype=npdt)
    args = [ell.vals, ell.cols, jnp.asarray(host["b"], npdt),
            jnp.asarray(host["active"]), jnp.asarray(host["y"], npdt),
            jnp.asarray(host["c_bar"], npdt), jnp.asarray(host["lb"], npdt),
            jnp.asarray(host["ub"], npdt), jnp.asarray(np.asarray(
                key, np.uint32))]
    if groups is not None:
        # compiled, as inside the solver's jitted outer iteration (XLA's
        # fusion decides how products and sums round)
        groups = tuple(jnp.asarray(g, jnp.int32) for g in groups)
        out = jax.jit(lambda *a: jda._dca_color_sweep(
            *a, groups, project=project))(*args)
    else:
        out = (jda._dca_sweep_ineq if project else jda._dca_sweep_eq)(*args)
    return [np.asarray(v) for v in out]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case", ["potts20", "sc105", "integer"])
def test_sequential_twin_matches_jax(case, project, dtype):
    npdt, tdt = DTYPES[dtype]
    host, d = _state(case, tdt)
    key = prng_key(3)
    y, c_bar, key_out = pdca.dca_sweep_reference(
        d["ell"], d["b"], d["active"], d["y"], d["c_bar"], d["lb"], d["ub"],
        key, project)
    wy, wc, wkey = _jax_sweep(host, npdt, key, project)
    np.testing.assert_array_equal(y.numpy(), wy)
    np.testing.assert_array_equal(c_bar.numpy(), wc)
    assert key_out == tuple(int(v) for v in wkey)


@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case", ["potts20", "matching", "integer"])
def test_color_twin_matches_jax(case, project):
    host, d = _state(case, torch.float64)
    groups = _color_rows(host["a"])
    key = prng_key(5)
    y, c_bar = d["y"], d["c_bar"]
    for rows in groups:
        key, sub = split(key)
        y, c_bar = pdca.dca_color_step_reference(
            d["ell"], d["b"], d["active"], y, c_bar, d["lb"], d["ub"],
            torch.as_tensor(rows), sub, project)
    wy, wc, wkey = _jax_sweep(host, np.float64, prng_key(5), project, groups)
    np.testing.assert_array_equal(y.numpy(), wy)
    np.testing.assert_array_equal(c_bar.numpy(), wc)
    assert key == tuple(int(v) for v in wkey)


def test_padded_row_unbounded_takes_no_step():
    """A row shorter than the width whose dual rises without bound along
    it: the padded search lands in the padding (+inf), the isfinite guard
    makes the step 0; the JAX sweep agrees."""
    a = scipy.sparse.csr_matrix(np.array([[1.0, 1.0, 0, 0], [1, 1, 1, 1]]))
    host = dict(a=a, b=np.array([-5.0, 10.0]), lb=np.zeros(4),
                ub=np.ones(4), y=np.zeros(2),
                c_bar=np.array([-0.5, -0.25, 1.0, 2.0]),
                active=np.array([True, False]))
    ell = pdca.EllRows.from_scipy(a, torch.float64, "cpu")
    t = {k: torch.as_tensor(host[k]) for k in ("b", "lb", "ub", "y",
                                                 "c_bar", "active")}
    y, c_bar, _ = pdca.dca_sweep_reference(
        ell, t["b"], t["active"], t["y"], t["c_bar"], t["lb"], t["ub"],
        prng_key(0), False)
    assert float(y[0]) == 0.0
    wy, wc, _ = _jax_sweep(host, np.float64, prng_key(0), False)
    np.testing.assert_array_equal(y.numpy(), wy)
    np.testing.assert_array_equal(c_bar.numpy(), wc)


def _bits(t):
    """``t``'s bits as integers: ``torch.equal`` on them tells -0 from 0."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same_bits(got, want):
    return (torch.equal(_bits(got[0]), _bits(want[0]))
            and torch.equal(_bits(got[1]), _bits(want[1]))
            and got[2:] == want[2:])


# the level counts of the schedule, a padding slot touching column 0
# (SC105's padded rows chain through it: without that rule its systems
# would have 18 and 6 levels)
LEVELS = {"potts20": 42, "potts50": 102, "sc105_eq": 21, "sc105_ineq": 42,
          "matching": 2}


def _schedule_rows(name):
    if name == "potts50":
        return _potts_rows(50)[0]
    if name.startswith("sc105"):
        from torch_port_helpers import sc105_lp

        lp = sc105_lp(port=True)[0]
        return (lp.a_equalities if name == "sc105_eq"
                else lp.a_inequalities).tocsr()
    return CASES[name]()[0]


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_level_counts(name):
    ell = pdca.EllRows.from_scipy(_schedule_rows(name), torch.float64, "cpu")
    assert ell.schedule.levels == LEVELS[name]
    assert ell.schedule.ptr.numel() == LEVELS[name] + 1


@pytest.mark.parametrize("case", ["potts20", "sc105", "matching", "integer",
                                  "integer6", "integer12"])
def test_level_schedule_properties(case):
    """Every row once; rows of a level pairwise column-disjoint (padding
    slots as column 0); each row's level above that of every earlier row
    sharing a column."""
    a = CASES[case]()[0]
    ell = pdca.EllRows.from_scipy(a, torch.float64, "cpu")
    perm, ptr = ell.schedule.perm.numpy(), ell.schedule.ptr.numpy()
    cols = ell.cols.numpy()
    m = cols.shape[0]
    assert ptr[0] == 0 and ptr[-1] == m and np.all(np.diff(ptr) > 0)
    assert np.array_equal(np.sort(perm), np.arange(m))
    level = np.empty(m, np.int64)
    for lv, (lo, hi) in enumerate(zip(ptr, ptr[1:])):
        level[perm[lo:hi]] = lv
        used = np.concatenate([np.unique(cols[i]) for i in perm[lo:hi]])
        assert np.unique(used).size == used.size, f"level {lv} shares a column"
    last = {}
    for i in range(m):
        for c in np.unique(cols[i]):
            if c in last:
                assert level[i] > level[last[c]]
            last[c] = i


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case", ["potts20", "sc105", "matching", "integer",
                                  "integer6", "integer12"])
def test_levels_twin_is_sequential_twin(case, project, dtype):
    """The sweep level by level gives the row-by-row sweep's bits: y, c̄
    (as integers, so -0 and 0 differ) and the key."""
    _npdt, tdt = DTYPES[dtype]
    _host, d = _state(case, tdt)
    args = (d["ell"], d["b"], d["active"], d["y"], d["c_bar"], d["lb"],
            d["ub"], prng_key(3), project)
    assert _same_bits(pdca.dca_sweep_levels_reference(*args),
                      pdca.dca_sweep_reference(*args))


def test_ell_rows_are_jax_ell_rows():
    from pysparselp_tpu.problem import EllMatrix
    from pysparselp_tpu_torch.utils.convert import ell_rows_from_jax

    a = _integer_rows()[0]
    got = pdca.EllRows.from_scipy(a, torch.float64, "cpu")
    want = ell_rows_from_jax(EllMatrix.from_scipy(a, dtype=np.float64),
                             torch.float64)
    assert torch.equal(got.vals, want.vals)
    assert torch.equal(got.cols, want.cols)


# ----------------------------------------------------------------------
# on the card: the kernel against the twin
# ----------------------------------------------------------------------


def _long_rows():
    """Rows at H-DCA's limit (MAX_ROW slots) and a short one."""
    rng = np.random.RandomState(9)
    n = 3000
    dense = np.zeros((3, n))
    for i, w in enumerate((pdca.MAX_ROW, pdca.MAX_ROW - 7, 5)):
        dense[i, rng.choice(n, w, replace=False)] = rng.choice(
            [-1.0, 1.0, 0.5], w)
    return (scipy.sparse.csr_matrix(dense), rng.randint(-20, 20, 3) * 1.0,
            rng.rand(n), np.zeros(n), np.ones(n))


def _wide_rows(m=3000, n=70000, seed=12):
    """Rows of 1 to 3 entries over more columns than a block's shared
    memory holds in either float type: c̄ in global memory."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(1, 4, m)
    rows = np.repeat(np.arange(m), cnt)
    # columns near the row's own stretch, so that rows chain into levels
    cols = (rows * (n // m) + rng.randint(0, 3 * (n // m), rows.size)) % n
    a = scipy.sparse.csr_matrix((rng.choice([-1.0, 1.0, 0.5], rows.size),
                                 (rows, cols)), shape=(m, n))
    a.sum_duplicates()
    return (a, rng.randint(-3, 4, m) * 1.0, rng.rand(n), np.zeros(n),
            np.ones(n))


CASES["long"] = _long_rows
CASES["wide"] = _wide_rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("project", [False, True], ids=["eq", "ineq"])
@pytest.mark.parametrize("case", ["potts20", "sc105", "matching", "integer",
                                  "integer6", "integer12", "long", "wide"])
def test_kernel_sweep_matches_twin(case, project, dtype):
    dev = cuda_or_skip()
    _npdt, tdt = DTYPES[dtype]
    _host, d = _state(case, tdt, device=dev)
    args = (d["ell"], d["b"], d["active"], d["y"], d["c_bar"], d["lb"],
            d["ub"], prng_key(11), project)
    before = pdca.dca_sweep.launches
    got = pdca.dca_sweep(*args)
    assert pdca.dca_sweep.launches == before + pdca.SWEEP_LAUNCHES
    assert _same_bits(got, pdca.dca_sweep_reference(*args))


def test_wide_case_keeps_cbar_in_global_memory():
    a = _wide_rows()[0]
    assert a.getnnz(axis=1).max() <= 3
    for itemsize in (4, 8):
        assert not pdca.cbar_in_smem(3, a.shape[1], itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["potts20", "matching", "long"])
def test_kernel_color_step_matches_twin(case, dtype):
    dev = cuda_or_skip()
    _npdt, tdt = DTYPES[dtype]
    host, d = _state(case, tdt, device=dev)
    groups = _color_rows(host["a"])
    y, c_bar = d["y"], d["c_bar"]
    wy, wc = y, c_bar
    key = prng_key(2)
    for rows in groups:
        key, sub = split(key)
        rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)
        y, c_bar = pdca.dca_color_step(d["ell"], d["b"], d["active"], y,
                                       c_bar, d["lb"], d["ub"], rows, sub,
                                       True)
        wy, wc = pdca.dca_color_step_reference(d["ell"], d["b"], d["active"],
                                               wy, wc, d["lb"], d["ub"], rows,
                                               sub, True)
        assert torch.equal(y, wy) and torch.equal(c_bar, wc)


@pytest.mark.cuda
def test_kernel_refuses_rows_past_its_limit():
    dev = cuda_or_skip()
    a = scipy.sparse.csr_matrix(np.ones((2, pdca.MAX_ROW + 1)))
    ell = pdca.EllRows.from_scipy(a, torch.float32, dev)
    z = torch.zeros(2, device=dev)
    zn = torch.zeros(pdca.MAX_ROW + 1, device=dev)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="MAX_ROW"):
        pdca.dca_sweep(ell, z, active, z, zn, zn, zn + 1, prng_key(0), True)
    with pytest.raises(ValueError, match="MAX_ROW"):
        pdca.dca_color_step(ell, z, active, z, zn, zn, zn + 1,
                            torch.arange(2, dtype=torch.int32, device=dev),
                            prng_key(0), True)


@pytest.mark.parametrize("case", ["potts20", "matching"])
def test_color_step_offset_draws_the_slice_of_the_group(case):
    """A group split in slices, each run with ``tie_offset`` at its first
    row, gives the whole group's step: the ties are the slices of the
    group's draw (``jax.random.uniform``'s element i hashes (0, i) whatever
    the draw's size), and the rows write disjoint entries."""
    host, d = _state(case, torch.float64)
    rows = torch.as_tensor(_color_rows(host["a"])[0], dtype=torch.int32)
    sub = split(prng_key(4))[1]
    want_y, want_c = pdca.dca_color_step_reference(
        d["ell"], d["b"], d["active"], d["y"], d["c_bar"], d["lb"],
        d["ub"], rows, sub, True)
    y, c_bar = d["y"], d["c_bar"]
    cut = [0, 1, rows.numel() // 3, rows.numel()]
    for lo, hi in zip(cut, cut[1:]):
        y, c_bar = pdca.dca_color_step(d["ell"], d["b"], d["active"], y,
                                       c_bar, d["lb"], d["ub"], rows[lo:hi],
                                       sub, True, tie_offset=lo)
    assert torch.equal(y, want_y) and torch.equal(c_bar, want_c)
    draws = uniform(sub, (rows.numel(),), torch.float64)
    assert torch.equal(uniform(sub, (rows.numel() - 5,), torch.float64,
                               offset=5), draws[5:])


def test_offset_draw_matches_jax_slice():
    """``uniform(key, shape, offset=k)`` is ``jax.random.uniform(key,
    (k + size,))[k:]``, float32 and float64."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(9)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        want = np.asarray(jax.random.uniform(key, (1000,), dtype=jdt))[337:]
        got = uniform(key_from_jax(key), (663,), tdt, offset=337)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["potts20", "matching", "long"])
def test_kernel_color_step_with_offset_matches_twin(case, dtype):
    """The colour step on slices of each group with their ``tie_offset``
    (a mesh rank's share) against the twin on the same slices, bit for
    bit, and the slices together against the whole group's step."""
    dev = cuda_or_skip()
    _npdt, tdt = DTYPES[dtype]
    host, d = _state(case, tdt, device=dev)
    key = prng_key(3)
    for rows in _color_rows(host["a"]):
        key, sub = split(key)
        rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)
        whole = pdca.dca_color_step(d["ell"], d["b"], d["active"], d["y"],
                                    d["c_bar"], d["lb"], d["ub"], rows, sub,
                                    True)
        y, c_bar = d["y"], d["c_bar"]
        wy, wc = y, c_bar
        half = (rows.numel() + 1) // 2
        for lo, hi in ((0, half), (half, rows.numel())):
            y, c_bar = pdca.dca_color_step(
                d["ell"], d["b"], d["active"], y, c_bar, d["lb"], d["ub"],
                rows[lo:hi], sub, True, tie_offset=lo)
            wy, wc = pdca.dca_color_step_reference(
                d["ell"], d["b"], d["active"], wy, wc, d["lb"], d["ub"],
                rows[lo:hi], sub, True, tie_offset=lo)
            assert torch.equal(y, wy) and torch.equal(c_bar, wc)
        assert torch.equal(y, whole[0]) and torch.equal(c_bar, whole[1])
