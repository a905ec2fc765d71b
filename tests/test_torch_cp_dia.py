"""H-CPDIA's twin (``cp_dia_chunk_reference``) against the JAX package's
fused CP kernels run in Pallas interpret mode (float32): the inequality-only
chunk ``cp_fused._cp_fused_call`` on an aligned Potts grid and the windowed
eq+ineq kernel ``cp_windowed._cp_windowed_call_full`` on a multi-label grid
(rtol 1e-5, atol 1e-6: the kernels sum the diagonal taps in other orders).

JAX is imported inside the parity tests: the card machine, which runs this
file's ``cuda`` cases (``python -m pytest --noconftest -m cuda``), has none."""

import pytest
import torch

from pysparselp_tpu_torch.examples.potts import (
    build_linear_program, build_multilabel_linear_program)
from pysparselp_tpu_torch.ops.cp_dia import (TWO_LAUNCH, cp_dia_chunk,
                                             cp_dia_chunk_reference,
                                             cp_dia_eligible, cp_dia_plan,
                                             cp_dia_resident_chunk)
from pysparselp_tpu_torch.utils.convert import problem_from_jax_arrays
from torch_port_helpers import (assert_close, assert_same_bits,
                                cuda_or_skip, host_system, jax_problem,
                                nan_signed_zero_case, port_problem,
                                start_point, torch_pre)

torch.set_num_threads(1)
F32 = torch.float32


def _potts_ineq():
    return host_system(build_linear_program(8, 0.5, 500, seed=1)[0],
                       align=True)


def _multilabel():
    return host_system(build_multilabel_linear_program(16, 3, seed=2)[0],
                       align=True)


def _inputs(sys_, seed):
    """JAX f32 problem, the port's copy of it, and a seeded start."""
    import jax.numpy as jnp

    jprob, jpre = jax_problem(sys_, "dia", jnp.float32)
    prob = problem_from_jax_arrays(jprob, dtype=F32, device="cpu")
    pre = torch_pre({k: v for k, v in jpre.items() if k != "theta"}, F32)
    x, ye, yi = start_point(sys_, seed)
    return jnp, jprob, jpre, prob, pre, x, ye, yi


@pytest.mark.parametrize("nsteps, with_sums", [(1, True), (20, True),
                                               (20, False)],
                         ids=["1", "20", "20-no-sums"])
def test_ineq_twin_matches_cp_fused_kernel(nsteps, with_sums):
    from pysparselp_tpu.ops import cp_fused

    jnp, jprob, jpre, prob, pre, x, _ye, yi = _inputs(_potts_ineq(), seed=0)
    assert prob.a_eq is None and cp_dia_eligible(prob)
    want = cp_fused._cp_fused_call(
        jprob, jpre, jnp.asarray(x, jnp.float32), jnp.asarray(yi, jnp.float32),
        nsteps, 1.0, interpret=True, with_sums=with_sums)
    got = cp_dia_chunk(prob, pre, torch.as_tensor(x, dtype=F32),
                       torch.zeros(0, dtype=F32),
                       torch.as_tensor(yi, dtype=F32), nsteps, 1.0,
                       with_sums=with_sums)
    # both of _cp_fused_call's contracts: (x, x3, y) and (x, x3, y, sx, sy)
    x_n, x3_n, _ye_n, y_n = got[:4]
    assert len(want) == (5 if with_sums else 3)
    assert_close([x_n, x3_n, y_n, *got[4::2]], want, rtol=1e-5,
                 atol=1e-6, what="cp_fused")


@pytest.mark.parametrize("nsteps", [1, 10])
def test_eq_ineq_twin_matches_windowed_kernel(monkeypatch, nsteps):
    from pysparselp_tpu.ops import cp_windowed

    # shrink the window budget so the grid spans several windows + halos
    monkeypatch.setattr(cp_windowed, "WINDOWED_VMEM_BUDGET", 2 * 1024 * 1024)
    monkeypatch.setattr(cp_windowed, "_MIN_WQ", 8)
    jnp, jprob, jpre, prob, pre, x, ye, yi = _inputs(_multilabel(), seed=1)
    assert prob.a_eq is not None and cp_dia_eligible(prob)
    plan = cp_windowed.window_layout(
        jprob.a_ineq.offsets, jprob.a_ineq.offsets_t, jprob.n,
        max(jprob.m_ineq, jprob.m_eq), 4,
        eq=(jprob.a_eq.offsets, jprob.a_eq.offsets_t, 4))
    assert plan is not None and plan[3] >= 2, plan
    want = cp_windowed._cp_windowed_call_full(
        jprob, jpre, jnp.asarray(x, jnp.float32),
        jnp.asarray(ye, jnp.float32), jnp.asarray(yi, jnp.float32), nsteps,
        1.0, interpret=True, with_sums=True)
    got = cp_dia_chunk(prob, pre, *(torch.as_tensor(v, dtype=F32)
                                    for v in (x, ye, yi)),
                       nsteps, 1.0, with_sums=True)
    assert_close(got, want, rtol=1e-5, atol=1e-6, what="cp_windowed")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [_potts_ineq, _multilabel])
def test_kernel_matches_twin_on_cuda(dtype, make):
    dev = cuda_or_skip()
    sys_ = make()
    prob, pre = port_problem(sys_, "dia", dtype, dev)
    args = [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in start_point(sys_, 3)]
    want = cp_dia_chunk_reference(prob, pre, *args, 50, 1.0, with_sums=True)
    # these small grids plan the resident tier: the two-launch kernel is
    # forced, then the planned tier runs too, each on its own counter
    for plan, counted in ((TWO_LAUNCH, cp_dia_chunk),
                          (cp_dia_plan(prob, dtype), cp_dia_resident_chunk)):
        launches = counted.launches
        got = cp_dia_chunk(prob, pre, *args, 50, 1.0, with_sums=True,
                           plan=plan)
        assert counted.launches == launches + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _nan_case(make, dtype, dev):
    sys_, start = nan_signed_zero_case(make(), seed=3)
    prob, pre = port_problem(sys_, "dia", dtype, dev)
    args = [torch.as_tensor(v, dtype=dtype, device=dev) for v in start]
    if prob.a_eq is None:
        args[1] = args[1][:0]
    return prob, pre, args


@pytest.mark.parametrize("make", [_potts_ineq, _multilabel])
def test_twin_keeps_a_nan_cost_and_bound(make):
    """The twin's projections (``torch.clamp``, ``torch.clamp_min``) keep a
    NaN: one NaN cost and one NaN lower bound reach x after one
    iteration, as JAX's ``jnp.clip`` keeps them."""
    prob, pre, args = _nan_case(make, torch.float64, "cpu")
    x = cp_dia_chunk(prob, pre, *args, 1, 1.0)[0]
    assert torch.isnan(x[3]) and torch.isnan(x[5])


@pytest.mark.cuda
@pytest.mark.parametrize("nsteps", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [_potts_ineq, _multilabel])
def test_kernel_keeps_nan_and_signed_zeros_on_cuda(make, dtype, nsteps):
    """The two-launch kernel and the planned tier against the twin on the
    card, bit for bit, on a NaN cost, a NaN bound and costs, bounds and
    iterates at -0.0 and +0.0: NaN positions and signed zeros included."""
    dev = cuda_or_skip()
    prob, pre, args = _nan_case(make, dtype, dev)
    want = cp_dia_chunk_reference(prob, pre, *args, nsteps, 1.0,
                                  with_sums=True)
    for plan in (TWO_LAUNCH, cp_dia_plan(prob, dtype)):
        got = cp_dia_chunk(prob, pre, *args, nsteps, 1.0, with_sums=True,
                           plan=plan)
        nans, negzeros = assert_same_bits(got, want, what=str(plan))
        assert nans and negzeros
