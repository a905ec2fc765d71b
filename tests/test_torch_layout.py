"""The port's layout chooser and its structured operators: the verbatim
copies (``partition_geometry``, ``_candidate_cuts``, ``col_split_plan``)
against the JAX package's, the sort-free diagonal count against
``dia_offsets``, ``PartitionMatrix``
and ``ColBlockMatrix`` against the JAX classes (float64, 1e-12), the
backends the chooser picks for the four non-grid workloads of ``bench.py``
and the aligned Potts grids, and the layout presolve's RCM + block-sparse
choice for the CLIME LP.

At these sizes every system is far under the dense limit, so the tests of
what the chooser picks patch ``DENSE_AUTO_MAX_ENTRIES`` down, as
``tests/test_problem.py`` does for the JAX package."""

import functools
import inspect

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import chip_smoke
import pysparselp_tpu.problem as jpr
import pysparselp_tpu_torch.problem as ppr
from pysparselp_tpu_torch.examples.potts import build_linear_program
from pysparselp_tpu_torch.examples.sparse_inv_covariance import (clime_lp,
                                                                 make_data)
from pysparselp_tpu_torch.ops import bsr_spmv
from pysparselp_tpu_torch.ops.cp_dense import cp_dense_eligible
from pysparselp_tpu_torch.ops.cp_dia import cp_dia_eligible
from pysparselp_tpu_torch.solvers.chambolle_pock import (_auto_layout,
                                                         _choose_layout)
from torch_port_helpers import host_system

torch.set_num_threads(1)
SMALL_DENSE_LIMIT = 100_000


@functools.lru_cache(maxsize=None)
def _system(name, **kw):
    if name == "potts_aligned":
        return host_system(build_linear_program(20, 0.5, 500, seed=1)[0],
                           align=True)
    return host_system(chip_smoke.WORKLOADS[name](**kw))


def _staircase():
    """``tests/test_problem.py:66-71``: three staircase bands."""
    rows = np.arange(20000).repeat(3)
    cols = np.stack([rows[::3], rows[::3] // 7 + 9000,
                     rows[::3] // 3 + 14000], 1).ravel()
    return scipy.sparse.coo_matrix(
        (np.ones(rows.size), (rows, np.clip(cols, 0, 19999))),
        shape=(20000, 20000)).tocsr()


MATRICES = {
    "kmedians_simplex": lambda: _system("kmedians", n_points=200,
                                        n_candidates=10)["a_eq"],
    "kmedians_folded": lambda: _system("kmedians", n_points=200,
                                       n_candidates=10)["a_ineq"],
    "l1svm_3000": lambda: _system("l1svm", nb_examples=3000)["a_ineq"],
    "staircase": _staircase,
}


@pytest.mark.parametrize("name", ["partition_geometry", "_candidate_cuts",
                                  "col_split_plan"])
def test_verbatim_copies(name):
    assert inspect.getsource(getattr(ppr, name)) == \
        inspect.getsource(getattr(jpr, name))
    for const in ("COL_SPLIT_MIN_GAIN", "COL_SPLIT_MAX_DEPTH",
                  "COL_SPLIT_TILE", "_COL_SPLIT_DENSITY_JUMP",
                  "DENSE_AUTO_MAX_ENTRIES"):
        assert getattr(ppr, const) == getattr(jpr, const)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_copies_give_equal_results(name):
    a = MATRICES[name]()
    assert ppr.partition_geometry(a) == jpr.partition_geometry(a)
    assert ppr._candidate_cuts(a) == jpr._candidate_cuts(a)
    if name == "l1svm_3000":   # 6,186 x 3,186, 378k entries
        assert a.shape == (6186, 3186) and ppr._candidate_cuts(a) == [93, 128]


def _jax_op(a, prefer):
    return jpr.ell_from_scipy(a, dtype=jnp.float64, prefer=prefer)


@pytest.mark.parametrize("name,prefer,kind", [
    ("kmedians_simplex", "partition", ppr.PartitionMatrix),
    ("kmedians_folded", "split", ppr.ColBlockMatrix),
    ("l1svm_300", "split", ppr.ColBlockMatrix),
])
def test_structured_operators_match_jax(name, prefer, kind, monkeypatch):
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    a = (_system("l1svm", nb_examples=300)["a_ineq"] if name == "l1svm_300"
         else MATRICES[name]())
    jop = _jax_op(a, prefer)
    op = ppr.ell_from_scipy(a, torch.float64, "cpu", prefer=prefer)
    assert isinstance(op, kind) and type(jop).__name__ == kind.__name__
    rng = np.random.RandomState(0)
    x, y = rng.randn(a.shape[1]), rng.randn(a.shape[0])
    pairs = [(op.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x))),
             (op.rmatvec(torch.as_tensor(y)), jop.rmatvec(jnp.asarray(y)))]
    for p in (0.0, 1.0, 2.0):
        pairs += [(op.abs_power_rowsum(p), jop.abs_power_rowsum(p)),
                  (op.abs_power_colsum(p), jop.abs_power_colsum(p))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(pairs[0][0].numpy(), a @ x, rtol=1e-12,
                               atol=1e-12)
    assert op.shape == a.shape


def _describe(op):
    if isinstance(op, ppr.ColBlockMatrix):
        return [_describe(b) for b in op.blocks]
    return type(op).__name__


@pytest.mark.parametrize("name,system,want", [
    ("transport", "a_eq", "CsrMatrix"),
    ("unstructured", "a_ineq", "CsrMatrix"),
    ("kmedians", "a_eq", "PartitionMatrix"),
    ("kmedians", "a_ineq", ["DiaMatrix", "DenseMatrix"]),
    ("l1svm", "a_ineq", ["DenseMatrix", "CsrMatrix"]),
    ("potts_aligned", "a_ineq", "DiaMatrix"),
])
def test_chooser_picks_for_workloads(name, system, want, monkeypatch):
    """What the chooser lowers the small workloads to (the dense limit
    patched down); column-block composites list their blocks.  None of
    them takes the block-sparse candidate."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    kw = {"transport": dict(n_sources=300, n_sinks=300, n_arcs=4000),
          "unstructured": dict(m=2000, n=1500),
          "kmedians": dict(n_points=200, n_candidates=10),
          "l1svm": dict(nb_examples=300), "potts_aligned": {}}[name]
    a = _system(name, **kw)[system]
    assert _describe(ppr.ell_from_scipy(a, torch.float64, "cpu")) == want


def test_aligned_potts_lowers_to_dia():
    """Unpatched, the aligned Potts-20 system prices DIA under dense and
    CSR, so the automatic layout aligns it."""
    sys_ = host_system(build_linear_program(20, 0.5, 500, seed=1)[0])
    mats = [sys_["a_eq"], sys_["a_ineq"]]
    plan = _auto_layout(mats)
    assert plan is not None
    aligned = host_system(build_linear_program(20, 0.5, 500, seed=1)[0],
                          align=True)["a_ineq"]
    assert aligned.shape[0] * aligned.shape[1] <= ppr.DENSE_AUTO_MAX_ENTRIES
    assert ppr.choose_layout(aligned)[:2] == ("dia", ())
    op = ppr.ell_from_scipy(aligned, torch.float64, "cpu")
    assert isinstance(op, ppr.DiaMatrix)
    assert ppr.lowers_to_dia(*aligned.shape, op.ndiag, aligned.nnz)


@pytest.mark.parametrize("prefer", ["ell", "segmented", "routed", "csr"])
def test_gather_layouts_map_to_csr(prefer):
    a = MATRICES["kmedians_simplex"]()
    assert isinstance(ppr.ell_from_scipy(a, torch.float64, "cpu",
                                         prefer=prefer), ppr.CsrMatrix)


def test_chunk_kernels_reject_column_blocks(monkeypatch):
    """A composite is never handed to a whole-chunk kernel, even when all
    its blocks are DIA or dense."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    a = MATRICES["kmedians_folded"]()
    for blocks in ("dia", "dense"):
        cuts = (2000,)
        op = ppr.ColBlockMatrix(
            blocks=tuple(ppr.ell_from_scipy(b, torch.float64, "cpu",
                                            prefer=blocks)
                         for b in (a[:, :2000], a[:, 2000:])),
            col_starts=(0,) + cuts + (a.shape[1],), nrows=a.shape[0],
            ncols=a.shape[1])
        prob = ppr.LPProblem(c=None, lb=None, ub=None, a_eq=None, b_eq=None,
                             a_ineq=op, b_lower=None, b_upper=None,
                             n=a.shape[1], m_eq=0, m_ineq=a.shape[0])
        assert not cp_dia_eligible(prob) and not cp_dense_eligible(prob)


def test_operator_cost_bytes_prices_blocks():
    a = MATRICES["kmedians_folded"]()
    op = ppr.ell_from_scipy(a, torch.float32, "cpu", prefer="split")
    assert ppr.operator_cost_bytes(op) == sum(
        ppr.operator_cost_bytes(b) for b in op.blocks) > 0
    a = MATRICES["staircase"]()
    op = ppr.ell_from_scipy(a, torch.float32, "cpu", prefer="bsr")
    assert isinstance(op, ppr.BsrMatrix)
    assert ppr.operator_cost_bytes(op) == ppr._bsr_candidate(
        a, torch.float32)
    # one tile set, read by each direction, or its longest line at one
    # warp's rate
    o = op.op
    assert op.nnz_padded == o.n_tiles * op.tile ** 2
    assert ppr.operator_cost_bytes(op) == sum(
        max(op.nnz_padded * 4 + ids * 4 * o.n_tiles + ptr.numel() * 4
            + sum(a.shape) * 4,
            ppr.warp_line_price(4) * line * op.tile ** 2 * 4)
        for ids, ptr, line in zip((1, 2), (o.row_ptr, o.col_ptr),
                                  o.longest_lines))


def test_bsr_price_counts_the_longest_tile_line(monkeypatch):
    """H-BSR gives each tile-column one warp: a system whose tile-column
    spans every tile-row (the L1-SVM weight head) is priced by that line
    at one warp's rate, above its tile set's bytes, and the chooser keeps
    the column split; the lowered operator is priced the same way."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    a = _system("l1svm", nb_examples=300)["a_ineq"]
    tiles, longest_row, longest_col = bsr_spmv.tile_counts(a)
    assert longest_col == -(-a.shape[0] // 16) - 8 and longest_row < 16
    m, n = a.shape
    stream_t = tiles * (1024 + 8) + (-(-n // 16) + 1) * 4 + (m + n) * 4
    line_t = ppr.warp_line_price(4) * longest_col * 1024
    assert line_t > stream_t
    cost = ppr._bsr_candidate(a, torch.float32)
    assert cost == ppr._bsr_bytes(tiles, (longest_row, longest_col), m, n,
                                  4) > line_t
    op = ppr.ell_from_scipy(a, torch.float32, "cpu", prefer="bsr")
    assert op.op.longest_lines == (longest_row, longest_col)
    assert ppr.operator_cost_bytes(op) == cost
    assert ppr.choose_layout(a)[:2] == ("split", (93,))
    # priced by its tile set alone, the system lowers to BSR
    assert ppr._bsr_candidate(a, torch.float32, 0) == ppr._bsr_bytes(
        tiles, (longest_row, longest_col), m, n, 4, line_price=0) < cost
    assert ppr.choose_layout(a, bsr_line_price=0)[:2] == ("bsr", ())


def test_bsr_line_price_follows_the_warp_batch():
    """The price of a tile-line is the card's rate over one warp's: a
    batch of 32 lanes × ``LANE_VALUES`` values per round trip of two
    loads.  Its one measurement: the 3,755-tile column (16×16, f32) of
    L1-SVM after RCM took 685-697 µs for Aᵀ y on the H100 (PERF.md, K6);
    the model gives 657 µs.  A float64 line moves twice the bytes per
    round trip, so its price per byte halves."""
    assert bsr_spmv.BsrOperand.warp_batch_bytes(4) == 32 * 32 * 4
    seconds = 3755 * 1024 * ppr.warp_line_price(4) / ppr.HBM_BYTES_PER_S
    assert 0.9 * 685e-6 < seconds < 1.1 * 697e-6
    assert ppr.warp_line_price(8) == ppr.warp_line_price(4) / 2


def test_clime_p80_takes_rcm_then_bsr(monkeypatch):
    """CLIME at p = 80 (12,800 variables, 25,600 folded rows, 1.05M
    entries): the layout presolve takes RCM, and the chooser lowers the
    permuted system to one set of 16×16 tiles, priced from the count of
    nonzero tiles alone (no tile is built): the tiles read once per
    product, three int32 ids per tile, the pointers and the vectors."""
    def no_tiles(*args, **kwargs):
        raise AssertionError("the chooser built tiles")

    monkeypatch.setattr(bsr_spmv, "build_tile_csr", no_tiles)
    lp, _ids = clime_lp(make_data(n_samples=160, n_features=80, seed=0)[0])
    sys_ = host_system(lp)
    assert sys_["a_eq"] is None and sys_["a_ineq"].shape == (25600, 12800)
    assert sys_["a_ineq"].nnz == 2 * 80 ** 3 + 4 * 80 ** 2
    choice, plan, layouts = _choose_layout([None, sys_["a_ineq"]])
    assert (choice, plan) == ("rcm", None)
    permuted = ppr.apply_rcm_permutation(sys_)[0]["a_ineq"]
    backend, cuts, cost = ppr.choose_layout(permuted)
    assert (backend, cuts) == ("bsr", ())
    assert layouts == [(None, None, 0), (backend, cuts, cost)]
    assert cost < min(ppr._candidates(permuted, torch.float32).values())
    assert cost < ppr.choose_layout(sys_["a_ineq"])[2]
    assert bsr_spmv.DEFAULT_TILE == 16
    tiles, *longest = bsr_spmv.tile_counts(permuted, 16)
    assert tiles * 256 < permuted.nnz * 2
    assert cost == ppr._bsr_bytes(tiles, longest, 25600, 12800, 4) == sum(
        max(tiles * (1024 + 4 * ids) + (lines + 1) * 4 + 38400 * 4,
            ppr.warp_line_price(4) * line * 1024)
        for ids, lines, line in zip((1, 2), (1600, 800), longest))


@pytest.mark.parametrize("name", sorted(MATRICES) + ["duplicates"])
def test_diagonal_count_matches_offsets(name):
    """The chooser's sort-free diagonal count is ``dia_offsets``' size up
    to ``DIA_AUTO_MAX_OFFSETS`` and above it past that; duplicate entries
    count once."""
    if name == "duplicates":
        # 20 rows of 40 entries over 7 columns: 26 diagonals
        a = scipy.sparse.csr_matrix(
            (np.ones(800), np.tile(np.arange(40) % 7, 20),
             np.arange(0, 801, 40)), shape=(20, 60))
        assert not a.has_canonical_format
    else:
        a = MATRICES[name]()
    want = ppr.dia_offsets(a).size
    got = ppr._diagonal_count(a)
    if want <= ppr.DIA_AUTO_MAX_OFFSETS:
        assert got == want
    else:
        assert got > ppr.DIA_AUTO_MAX_OFFSETS


@pytest.mark.parametrize("name,kw", [
    ("kmedians", dict(n_points=200, n_candidates=10)),
    ("l1svm", dict(nb_examples=300)),
])
def test_lowering_reuses_presolve_layouts(name, kw, monkeypatch):
    """The layouts the presolve priced lower to the operators the lowering
    would choose alone, without searching the systems again."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    sys_ = _system(name, **kw)
    mats = [sys_["a_eq"], sys_["a_ineq"]]
    choice, _plan, layouts = _choose_layout(mats)
    assert choice is None
    searched = []
    search = ppr.col_split_plan

    def counted(csr, *args, **kwargs):
        searched.append(csr.shape)
        return search(csr, *args, **kwargs)

    monkeypatch.setattr(ppr, "col_split_plan", counted)
    alone = ppr.lower_systems(mats, torch.float64, "cpu")
    n_alone = len(searched)
    searched.clear()
    reused = ppr.lower_systems(mats, torch.float64, "cpu", layouts=layouts)
    assert [_describe(o) for o in reused] == [_describe(o) for o in alone]
    assert not any(a is not None and a.shape in searched for a in mats)
    assert len(searched) < n_alone
