"""The port's XorShift (a verbatim copy of the JAX package's
``utils/xorshift.py``): the counterparts of ``tests/test_xorshift.py``, the
Mehrotra self-test on the port's interior point (float64, on the CPU), and
the port's stream equal to the JAX package's."""

import numpy as np
import scipy.optimize
import scipy.sparse
import torch

from pysparselp_tpu.utils import XorShift as JaxXorShift
from pysparselp_tpu_torch.solvers.mehrotra import mpc_sol
from pysparselp_tpu_torch.utils import XorShift

torch.set_num_threads(1)


def test_xorshift_stream_is_deterministic():
    g1, g2 = XorShift(), XorShift()
    s1 = [g1.next_value() for _ in range(5)]
    s2 = [g2.next_value() for _ in range(5)]
    assert s1 == s2
    assert all(0 <= v < 2**32 for v in s1)
    r = XorShift().rand(3, 4)
    assert r.shape == (3, 4) and np.all((r >= 0) & (r < 1))
    z = XorShift().randn(2, 500)
    assert abs(z.mean()) < 0.2 and abs(z.std() - 1) < 0.2


def test_mehrotra_selftest_on_xorshift_instance():
    rng = XorShift()
    m, n = 12, 30
    a = rng.rand(m, n)
    xfeas = rng.rand(n, 1).ravel()
    b = a @ xfeas
    c = rng.rand(n, 1).ravel()

    f, x, y, s, niter = mpc_sol(scipy.sparse.csr_matrix(a), b, c,
                                max_iter=60, dtype=np.float64, device="cpu")
    assert np.all(np.isfinite(x)) and np.all(x >= -1e-9)
    assert np.abs(a @ x - b).max() < 1e-7
    # primal-dual optimality: complementarity gap closed
    assert abs(np.dot(x, s)) / (1 + abs(np.dot(c, x))) < 1e-7
    ref = scipy.optimize.linprog(c, A_eq=a, b_eq=b, bounds=(0, None)).fun
    assert abs(float(f) - ref) < 1e-6


def test_stream_equals_jax():
    """10,000 integer draws, then uniform, normal and integer draws from a
    seeded state: the two packages' streams are equal."""
    g_p, g_j = XorShift(), JaxXorShift()
    assert [g_p.next_value() for _ in range(10_000)] == [
        g_j.next_value() for _ in range(10_000)]
    seed = (1, 2, 3, 4)
    g_p, g_j = XorShift(*seed), JaxXorShift(*seed)
    np.testing.assert_array_equal(g_p.rand(7, 9), g_j.rand(7, 9))
    np.testing.assert_array_equal(g_p.randn(5, 6), g_j.randn(5, 6))
    assert [g_p.randint(0, 99) for _ in range(50)] == [
        g_j.randint(0, 99) for _ in range(50)]
    assert g_p.choice("abcdef") == g_j.choice("abcdef")
