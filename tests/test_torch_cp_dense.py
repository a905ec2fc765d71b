"""H-CPDENSE's twin (``cp_dense_chunk_reference``) against the JAX package's
dense fused CP kernel ``cp_fused._cp_dense_fused_call`` run in Pallas
interpret mode, on netlib SC105 in float32 (rtol 1e-5: the kernels sum the
dense products in other orders).

JAX is imported inside the parity test: the card machine, which runs this
file's ``cuda`` case (``python -m pytest --noconftest -m cuda``), has none."""

import numpy as np
import pytest
import scipy.sparse
import torch

from pysparselp_tpu_torch.ops.cp_dense import (SMEM_LIMIT, cp_dense_chunk,
                                               cp_dense_chunk_reference,
                                               cp_dense_eligible,
                                               dense_layout)
from pysparselp_tpu_torch.utils.convert import problem_from_jax_arrays
from torch_port_helpers import (assert_close, assert_same_bits,
                                cuda_or_skip, host_system, jax_problem,
                                nan_signed_zero_case, port_problem, sc105_lp,
                                start_point, torch_pre)

torch.set_num_threads(1)


def _sc105():
    return host_system(sc105_lp(port=True)[0])


@pytest.mark.parametrize("with_sums", [False, True])
def test_twin_matches_dense_fused_kernel(with_sums):
    import jax.numpy as jnp

    from pysparselp_tpu.ops import cp_fused

    sys_ = _sc105()
    jprob, jpre = jax_problem(sys_, "dense", jnp.float32)
    prob = problem_from_jax_arrays(jprob, dtype=torch.float32, device="cpu")
    pre = torch_pre({k: v for k, v in jpre.items() if k != "theta"},
                    torch.float32)
    x, ye, yi = start_point(sys_, seed=4)
    assert cp_dense_eligible(prob)
    want = cp_fused._cp_dense_fused_call(
        jprob, jpre, *(jnp.asarray(v, jnp.float32) for v in (x, ye, yi)),
        10, 1.0, interpret=True, with_sums=with_sums)
    got = cp_dense_chunk(prob, pre, *(torch.as_tensor(v, dtype=torch.float32)
                                      for v in (x, ye, yi)),
                         10, 1.0, with_sums=with_sums)
    assert len(got) == len(want)
    assert_close(got, want, rtol=1e-5, atol=1e-5, what="cp_dense")


def _dense_system(me, mi, n, seed):
    """A random dense LP host system (``torch_port_helpers.host_system``'s
    keys) with a feasible point inside ``[0, 1]``."""
    rng = np.random.RandomState(seed)

    def mat(m):
        if not m:
            return None
        a = rng.randn(m, n) * (rng.rand(m, n) < 0.3)
        return scipy.sparse.csr_matrix(a)

    a_eq, a_in = mat(me), mat(mi)
    xf = rng.rand(n)
    return dict(a_eq=a_eq, beq=None if a_eq is None else a_eq @ xf,
                a_ineq=a_in, b_ineq=None if a_in is None else a_in @ xf + 0.5,
                c=rng.randn(n), lb=np.zeros(n), ub=np.ones(n))


# systems by the kernel's size tier: SC105 in shared memory; operators past
# shared memory (2 x 250 x 300 entries) in the L2 tier; a 7,000-column
# system whose float64 state (7n + 4m entries) exceeds shared memory too
SYSTEMS = {"sc105": _sc105,
           "past_shared": lambda: _dense_system(150, 100, 300, 11),
           "wide": lambda: _dense_system(8, 12, 7000, 12)}
TIERS = {("sc105", 4): "shared", ("sc105", 8): "shared",
         ("past_shared", 4): "l2", ("past_shared", 8): "l2",
         ("wide", 4): "l2", ("wide", 8): "global"}


@pytest.mark.parametrize("name,itemsize", sorted(TIERS))
def test_dense_layout_tiers(name, itemsize):
    """What shared memory holds per system and dtype; every output gets a
    group of lanes within the block, and the padded rows and columns hold
    whole steps of 16-byte vectors."""
    sys_ = SYSTEMS[name]()
    me = 0 if sys_["a_eq"] is None else sys_["a_eq"].shape[0]
    mi = sys_["a_ineq"].shape[0]
    n = len(sys_["c"])
    lay = dense_layout(n, me, mi, itemsize)
    tier = ("shared" if lay["ops_smem"] else "l2" if lay["state_smem"]
            else "global")
    assert tier == TIERS[name, itemsize]
    assert lay["smem_bytes"] <= SMEM_LIMIT
    total = lay["state"] + (me + mi) * lay["ld_a"] + n * lay["ld_t"]
    assert lay["scratch"] == (0 if tier == "shared" else total)
    vec = 16 // itemsize
    for outputs, w in ((n, lay["w1"]), (me + mi, lay["w2"])):
        assert 1 <= w <= 32 and (w == 1 or 1024 // w >= outputs)
    assert lay["ld_a"] >= n and lay["ld_a"] % (vec * lay["w2"]) == 0
    assert lay["ld_t"] >= me + mi and lay["ld_t"] % (vec * lay["w1"]) == 0
    threads = lay["threads"]
    assert threads % 32 == 0 and threads <= 1024
    assert threads >= min(1024, n * lay["w1"], (me + mi) * lay["w2"])
    if name == "sc105":
        # at most LANE_STEPS 16-byte steps a lane per output
        assert (lay["w1"], lay["w2"]) == {4: (4, 4), 8: (8, 8)}[itemsize]
        assert (lay["ld_a"], lay["ld_t"], threads) == {
            4: (112, 112, 448), 8: (112, 112, 864)}[itemsize]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernel_matches_twin_on_cuda(dtype, rtol, name):
    """Kernel and twin sum the products in different orders: the error is
    held normwise, ``max|kernel - twin| <= rtol * max(1, max|twin|)``, on
    every size tier and at 1 and 32 lanes per output; the inputs stay as
    they were."""
    dev = cuda_or_skip()
    sys_ = SYSTEMS[name]()
    prob, pre = port_problem(sys_, "dense", dtype, dev)
    args = [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in start_point(sys_, 4)]
    before = [a.clone() for a in args]
    launches = cp_dense_chunk.launches
    got = cp_dense_chunk(prob, pre, *args, 200, 1.0, with_sums=True)
    want = cp_dense_chunk_reference(prob, pre, *args, 200, 1.0,
                                    with_sums=True)
    assert cp_dense_chunk.launches == launches + 1
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    for g, w in zip(got, want):
        if w.numel():
            scale = max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= rtol * scale, name
    assert all(torch.equal(g, w) for g, w in zip(
        cp_dense_chunk(prob, pre, *args, 0, 1.0), args[:1] * 2 + args[1:]))
    # one lane per output, and 32 (several rounds of outputs per group)
    for lanes in (1, 32):
        got = cp_dense_chunk(prob, pre, *args, 200, 1.0, with_sums=True,
                             lanes=lanes)
        for g, w in zip(got, want):
            if w.numel():
                scale = max(1.0, float(w.abs().max()))
                assert float((g - w).abs().max()) <= rtol * scale, (name,
                                                                     lanes)


def _diagonal_system(n=48, me=12, mi=24, seed=13):
    """A dense LP whose rows each hold one entry, each in its own column:
    every product of the kernel and of the twin adds one term and zeros,
    in any order the same bits."""
    rng = np.random.RandomState(seed)
    vals = rng.rand(me + mi) + 0.5
    a = scipy.sparse.csr_matrix((vals, (np.arange(me + mi),
                                        np.arange(me + mi))),
                                shape=(me + mi, n))
    return dict(a_eq=a[:me], beq=rng.rand(me), a_ineq=a[me:],
                b_ineq=rng.rand(mi) + 0.5, c=rng.randn(n), lb=np.zeros(n),
                ub=np.ones(n))


def test_twin_keeps_a_nan_cost_and_bound():
    sys_, start = nan_signed_zero_case(_diagonal_system(), seed=4)
    prob, pre = port_problem(sys_, "dense", torch.float64)
    x = cp_dense_chunk(prob, pre, *(torch.as_tensor(v, dtype=torch.float64)
                                    for v in start), 1, 1.0)[0]
    assert torch.isnan(x[3]) and torch.isnan(x[5])


@pytest.mark.cuda
@pytest.mark.parametrize("nsteps", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_keeps_nan_and_signed_zeros_on_cuda(dtype, nsteps):
    """H-CPDENSE against the twin on the card, bit for bit, on a NaN cost,
    a NaN bound and costs, bounds and iterates at -0.0 and +0.0 (a
    one-entry-per-row system, so the sums cannot differ by order)."""
    dev = cuda_or_skip()
    sys_, start = nan_signed_zero_case(_diagonal_system(), seed=4)
    prob, pre = port_problem(sys_, "dense", dtype, dev)
    args = [torch.as_tensor(v, dtype=dtype, device=dev) for v in start]
    want = cp_dense_chunk_reference(prob, pre, *args, nsteps, 1.0,
                                    with_sums=True)
    for lanes in (None, 1):
        kw = {} if lanes is None else dict(lanes=lanes)
        got = cp_dense_chunk(prob, pre, *args, nsteps, 1.0, with_sums=True,
                             **kw)
        nans, negzeros = assert_same_bits(got, want, what=f"lanes={lanes}")
        # the dense products carry the NaN to every entry by the second
        # iteration, so the signed zeros show after the first
        assert nans and (negzeros or nsteps > 1)
