"""H-CPDENSE's twin (``cp_dense_chunk_reference``) against the JAX package's
dense fused CP kernel ``cp_fused._cp_dense_fused_call`` run in Pallas
interpret mode, on netlib SC105 in float32 (rtol 1e-5: the kernels sum the
dense products in other orders).

JAX is imported inside the parity test: the card machine, which runs this
file's ``cuda`` case (``python -m pytest --noconftest -m cuda``), has none."""

import pytest
import torch

from pysparselp_tpu_torch.ops.cp_dense import (cp_dense_chunk,
                                               cp_dense_chunk_reference,
                                               cp_dense_eligible)
from pysparselp_tpu_torch.utils.convert import problem_from_jax_arrays
from torch_port_helpers import (assert_close, cuda_or_skip, host_system,
                                      jax_problem, port_problem, sc105_lp,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernel_matches_twin_on_cuda(dtype, rtol):
    """Kernel and twin sum the products in different orders: the error is
    held normwise, ``max|kernel - twin| <= rtol * max(1, max|twin|)``."""
    dev = cuda_or_skip()
    sys_ = _sc105()
    prob, pre = port_problem(sys_, "dense", dtype, dev)
    args = [torch.as_tensor(v, dtype=dtype, device=dev)
            for v in start_point(sys_, 4)]
    launches = cp_dense_chunk.launches
    got = cp_dense_chunk(prob, pre, *args, 200, 1.0, with_sums=True)
    want = cp_dense_chunk_reference(prob, pre, *args, 200, 1.0,
                                    with_sums=True)
    assert cp_dense_chunk.launches == launches + 1
    for g, w in zip(got, want):
        if w.numel():
            scale = max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= rtol * scale
