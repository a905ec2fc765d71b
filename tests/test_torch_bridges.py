"""The port's host bridges (``method="scipy_simplex"`` and
``"scipy_interior_point"``: HiGHS through scipy, verbatim copies of the
JAX package's ``solvers/scipy_bridge.py`` and ``highs_bridge.py``) give the
JAX package's solution and convergence curve, on netlib SC105 and on a
``generate_random_lp`` LP, whatever ``device`` says."""

import numpy as np
import pytest
import torch

from pysparselp_tpu.utils.random_lp import generate_random_lp as jax_random
from pysparselp_tpu_torch.solvers import _NOT_PORTED
from pysparselp_tpu_torch.utils.random_lp import (
    generate_random_lp as port_random)
from torch_port_helpers import sc105_lp

torch.set_num_threads(1)
METHODS = ["scipy_simplex", "scipy_interior_point"]


def _pair(name):
    if name == "sc105":
        return sc105_lp()[0], sc105_lp(port=True)[0]
    kw = dict(nbvar=60, n_eq=10, n_ineq=40, sparsity=0.2, seed=17)
    return jax_random(**kw)[0], port_random(**kw)[0]


@pytest.mark.parametrize("name", ["sc105", "random"])
@pytest.mark.parametrize("method", METHODS)
def test_bridge_matches_jax(method, name):
    lp_jax, lp_port = _pair(name)
    run = dict(method=method, nb_iter=100_000, nb_iter_plot=20)
    want, _ = lp_jax.solve(**run)
    # the bridges run on the host: the default device="cuda" is not asked
    got, _ = lp_port.solve(**run)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert lp_port.itrn_curve == lp_jax.itrn_curve
    np.testing.assert_allclose(lp_port.pobj_curve, lp_jax.pobj_curve,
                               rtol=1e-12, atol=1e-12)
    assert lp_port.max_constraint_violation(got) < 1e-6


@pytest.mark.parametrize("method", METHODS)
def test_bridges_are_ported(method):
    assert method not in _NOT_PORTED
