"""``pysparselp_tpu_torch.utils.convert``: a JAX ``LPProblem`` and solver
state carried to the port, and the port's per-operator chunk, restart
controller and KKT score against JAX's on the carried problem (float64,
1e-12)."""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import chip_smoke
from pysparselp_tpu import problem as jpr
from pysparselp_tpu.examples.potts import (build_linear_program,
                                           build_multilabel_linear_program)
from pysparselp_tpu.solvers import chambolle_pock as jcp
from pysparselp_tpu_torch.problem import (BsrMatrix, ColBlockMatrix,
                                          CsrMatrix, DenseMatrix, DiaMatrix,
                                          PartitionMatrix)
from pysparselp_tpu_torch.solvers import chambolle_pock as pcp
from pysparselp_tpu_torch.utils.convert import (operator_from_jax,
                                                problem_from_jax_arrays,
                                                state_from_numpy,
                                                state_to_numpy)
from torch_port_helpers import (host_system, jax_problem, sc105_lp,
                                start_point, torch_pre)

torch.set_num_threads(1)
F64 = jnp.float64


def _transport():
    return host_system(chip_smoke.transport_lp(n_sources=60, n_sinks=60,
                                               n_arcs=500))


def _kmedians():
    return host_system(chip_smoke.kmedians_lp(n_points=40, n_candidates=6))


def _l1svm():
    return host_system(chip_smoke.l1svm_lp(nb_examples=200))


CASES = {
    # (host system, JAX backend(s), port operator type(s))
    "sc105_dense": (lambda: host_system(sc105_lp()[0]), "dense", DenseMatrix),
    "sc105_ell": (lambda: host_system(sc105_lp()[0]), "ell", CsrMatrix),
    "sc105_bsr": (lambda: host_system(sc105_lp()[0]), "bsr", BsrMatrix),
    "potts_dia": (lambda: host_system(
        build_linear_program(10, 0.5, 500, seed=1)[0], align=True),
        "dia", DiaMatrix),
    "multilabel_dia": (lambda: host_system(
        build_multilabel_linear_program(6, 3, seed=2)[0], align=True),
        "dia", DiaMatrix),
    "transport_segmented": (_transport, "segmented", CsrMatrix),
    "kmedians_partition_split": (_kmedians, ("partition", "split"),
                                 (PartitionMatrix, ColBlockMatrix)),
    "l1svm_split": (_l1svm, "split", ColBlockMatrix),
}


def _carried(case):
    make, backend, kinds = CASES[case]
    sys_ = make()
    jprob, jpre = jax_problem(sys_, backend, F64)
    prob = problem_from_jax_arrays(jprob, device="cpu")
    kinds = kinds if isinstance(kinds, tuple) else (kinds,) * 2
    for op, kind in zip((prob.a_eq, prob.a_ineq), kinds):
        assert op is None or isinstance(op, kind)
    return sys_, jprob, jpre, prob, torch_pre(jpre, torch.float64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_operators_carry_across(case):
    _sys, jprob, _jpre, prob, _pre = _carried(case)
    assert prob.c.dtype == torch.float64
    rng = np.random.RandomState(0)
    for jop, op in ((jprob.a_eq, prob.a_eq), (jprob.a_ineq, prob.a_ineq)):
        if jop is None:
            assert op is None
            continue
        x, y = rng.randn(op.ncols), rng.randn(op.nrows)
        np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(),
                                   np.asarray(jop.matvec(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                                   np.asarray(jop.rmatvec(jnp.asarray(y))),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(op.abs_power_colsum(1.0).numpy(),
                                   np.asarray(jop.abs_power_colsum(1.0)),
                                   rtol=1e-12)


def _state(sys_, seed):
    x, ye, yi = start_point(sys_, seed)
    return (x, x * 0.5, ye, yi)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cp_chunk_and_kkt_match_jax(case):
    sys_, jprob, jpre, prob, pre = _carried(case)
    st = _state(sys_, 1)
    js, jm = jcp._cp_chunk(jprob, jpre, tuple(jnp.asarray(v) for v in st), 20)
    ps, pm = pcp.cp_chunk_impl(prob, pre, state_from_numpy(st), 20)
    for a, b in zip(state_to_numpy(ps), js):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-12)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    jk = jcp._kkt_score(jprob, *(jnp.asarray(st[i]) for i in (0, 2, 3)))
    pk = pcp._kkt_score(prob, *state_from_numpy([st[i] for i in (0, 2, 3)]))
    np.testing.assert_allclose(float(pk), float(jk), rtol=1e-12)


@pytest.mark.parametrize("case", ["sc105_ell", "multilabel_dia"])
def test_restart_controller_matches_jax(case):
    """One device-resident restart chunk from the same carried rstate."""
    sys_, jprob, jpre, prob, pre = _carried(case)
    st = _state(sys_, 2)
    rstate = {"state": st, "omega": 1.3, "mu_restart": 10.0,
              "mu_last": np.inf, "zx": st[0], "zeq": st[2], "zineq": st[3]}
    jr = {k: (tuple(jnp.asarray(v) for v in val) if k == "state"
              else jnp.asarray(val, F64)) for k, val in rstate.items()}
    jr_new, jm = jcp._cp_chunk_restart_device(jprob, jpre, jr, 70, 20)
    st_t, pr = state_from_numpy(st, rstate)
    assert pr["state"][0] is not st_t[0]
    pr_new, pm = pcp._cp_chunk_restart_device(prob, pre, pr, 70, 20)
    got, want = state_to_numpy(pr_new), jr_new
    for k in ("omega", "mu_restart", "mu_last", "zx", "zeq", "zineq"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(pm["energy1"]), float(jm["energy1"]),
                               rtol=1e-12)


def test_state_round_trip():
    st = tuple(np.random.RandomState(3).randn(k) for k in (5, 5, 0, 4))
    rstate = {"state": st, "omega": 2.0, "mu_restart": 1.5,
              "mu_last": np.inf, "zx": st[0], "zeq": st[2], "zineq": st[3]}
    back_st = state_to_numpy(state_from_numpy(st))
    back_st2, back_r = state_to_numpy(state_from_numpy(st, rstate))
    for a, b, c in zip(st, back_st, back_st2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert back_r["omega"] == 2.0 and np.isinf(back_r["mu_last"])


def test_segmented_ell_of_the_cpu_lowering():
    """The JAX package lowers the transport equality system to a
    SegmentedEllMatrix off the TPU; the port carries it as CSR."""
    a = _transport()["a_eq"]
    jop = jpr.ell_from_scipy(a, dtype=F64)
    assert type(jop).__name__ == "SegmentedEllMatrix"
    op = operator_from_jax(jop, torch.float64, "cpu")
    assert isinstance(op, CsrMatrix)
    x = np.random.RandomState(4).randn(a.shape[1])
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)


def test_routed_ell_carries_its_entries():
    """A RoutedEllMatrix (float32 only on the JAX side) comes across
    through its decoded routes."""
    from pysparselp_tpu.ops.ell_routed import RoutedEllMatrix

    a = scipy.sparse.random(300, 200, density=0.03, format="csr",
                            random_state=np.random.RandomState(9))
    jop = RoutedEllMatrix.from_scipy(a, dtype=jnp.float32)
    op = operator_from_jax(jop, torch.float32, "cpu")
    assert isinstance(op, CsrMatrix) and op.shape == a.shape
    y = np.random.RandomState(5).randn(300).astype(np.float32)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               np.asarray(jop.rmatvec(jnp.asarray(y))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               a.T @ y, rtol=2e-5, atol=2e-5)


def test_unknown_operator_raises():
    class Mystery:
        nrows = ncols = 1

    with pytest.raises(TypeError, match="no port counterpart"):
        operator_from_jax(Mystery(), torch.float64, "cpu")


@pytest.mark.parametrize("shape,offsets", [((60, 75), (0, 5, -2)),
                                           ((90, 40), (-30, -1, 0, 3))])
def test_xla_dia_carries_across(shape, offsets):
    """The JAX batched solver's ``XlaDiaMatrix`` comes across as the port's
    ``DiaMatrix`` plane for plane: 1-D and batch-last products equal the
    JAX operator's (its batch under ``jax.vmap``)."""
    import jax

    from pysparselp_tpu.batch import XlaDiaMatrix

    m, n = shape
    rng = np.random.RandomState(6)
    a = scipy.sparse.diags(
        [rng.randn(min(m - max(0, -o), n - max(0, o))) for o in offsets],
        offsets, shape=shape).tocsr()
    jop = XlaDiaMatrix.from_scipy(a, F64)
    op = operator_from_jax(jop, torch.float64, "cpu")
    assert isinstance(op, DiaMatrix) and op.shape == shape
    assert op.offsets == jop.offsets and op.offsets_t == jop.offsets_t
    np.testing.assert_array_equal(op.vals.numpy(), np.asarray(jop.vals))
    np.testing.assert_array_equal(op.vals_t.numpy(), np.asarray(jop.vals_t))
    x, y = rng.randn(n, 3), rng.randn(m, 3)
    np.testing.assert_allclose(
        op.matvec(torch.as_tensor(x)).numpy(),
        np.asarray(jax.vmap(jop.matvec)(jnp.asarray(x.T))).T, rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        op.rmatvec(torch.as_tensor(y[:, 0])).numpy(),
        np.asarray(jop.rmatvec(jnp.asarray(y[:, 0]))), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(y)).numpy(),
                               a.T @ y, rtol=1e-12, atol=1e-12)
