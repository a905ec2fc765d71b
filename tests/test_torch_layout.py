"""The port's layout chooser and its structured operators: the verbatim
copies (``partition_geometry``, ``_candidate_cuts``, ``col_split_plan``,
``effective_stream_bytes``) against the JAX package's, ``PartitionMatrix``
and ``ColBlockMatrix`` against the JAX classes (float64, 1e-12), and the
backends the chooser picks for the four non-grid workloads of ``bench.py``
and the aligned Potts grids.

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
from pysparselp_tpu_torch.ops.cp_dense import cp_dense_eligible
from pysparselp_tpu_torch.ops.cp_dia import cp_dia_eligible
from pysparselp_tpu_torch.solvers.chambolle_pock import _auto_layout
from torch_port_helpers import host_system

torch.set_num_threads(1)
SMALL_DENSE_LIMIT = 100_000


@functools.lru_cache(maxsize=None)
def _system(name, **kw):
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
                                  "col_split_plan", "effective_stream_bytes"])
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
])
def test_chooser_picks_for_workloads(name, system, want, monkeypatch):
    """What the chooser lowers the small workloads to (the dense limit
    patched down); column-block composites list their blocks."""
    monkeypatch.setattr(ppr, "DENSE_AUTO_MAX_ENTRIES", SMALL_DENSE_LIMIT)
    kw = {"transport": dict(n_sources=300, n_sinks=300, n_arcs=4000),
          "unstructured": dict(m=2000, n=1500),
          "kmedians": dict(n_points=200, n_candidates=10),
          "l1svm": dict(nb_examples=300)}[name]
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
    assert ppr.choose_layout(aligned) == ("dia", ())
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
