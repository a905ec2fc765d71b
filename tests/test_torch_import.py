"""The port stands alone: it imports torch and never jax, resolves its
device and dtype explicitly, and names the ROADMAP item of what it does
not port yet."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pysparselp_tpu_torch import SparseLP
from pysparselp_tpu_torch.problem import resolve_device, resolve_dtype

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "pysparselp_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, pysparselp_tpu_torch, pysparselp_tpu_torch.solvers."
            "chambolle_pock, pysparselp_tpu_torch.utils.convert, "
            "pysparselp_tpu_torch.examples.potts, pysparselp_tpu_torch.io, "
            "pysparselp_tpu_torch.ops.csr_spmv, "
            "pysparselp_tpu_torch.ops.bsr_spmv, "
            "pysparselp_tpu_torch.examples.l1_svm, "
            "pysparselp_tpu_torch.examples.kmedians, "
            "pysparselp_tpu_torch.examples.sparse_inv_covariance, "
            "pysparselp_tpu_torch.parallel.mesh, "
            "pysparselp_tpu_torch.parallel.sharded_dia, "
            "pysparselp_tpu_torch.parallel.sharded_cp, "
            "pysparselp_tpu_torch.parallel.sharded_mehrotra, "
            "pysparselp_tpu_torch.parallel.sharded_admm, "
            "pysparselp_tpu_torch.parallel.sharded_dga, "
            "pysparselp_tpu_torch.parallel.sharded_dca, "
            "pysparselp_tpu_torch.batch, "
            "pysparselp_tpu_torch.solvers.scipy_bridge, "
            "pysparselp_tpu_torch.solvers.highs_bridge, "
            "pysparselp_tpu_torch.utils.random_lp, "
            "pysparselp_tpu_torch.preconditioning, "
            "pysparselp_tpu_torch.ops.cg, "
            "pysparselp_tpu_torch.ops.linear_solve, "
            "pysparselp_tpu_torch.solvers.mehrotra, "
            "pysparselp_tpu_torch.solvers.admm, "
            "pysparselp_tpu_torch.examples.basis_pursuit_denoising, "
            "pysparselp_tpu_torch.utils.jax_prng, "
            "pysparselp_tpu_torch.ops.linesearch, "
            "pysparselp_tpu_torch.ops.dca_sweep, "
            "pysparselp_tpu_torch.integer, "
            "pysparselp_tpu_torch.integer.rounding, "
            "pysparselp_tpu_torch.integer.propagation, "
            "pysparselp_tpu_torch.solvers.dual_ascent, "
            "pysparselp_tpu_torch.solvers.admm_blocks, "
            "pysparselp_tpu_torch.examples.bipartite_matching, "
            "pysparselp_tpu_torch.native, "
            "pysparselp_tpu_torch.native.gauss_seidel, "
            "pysparselp_tpu_torch.io.ian_yen, "
            "pysparselp_tpu_torch.solvers.osqp_bridge, "
            "pysparselp_tpu_torch.solvers.cvxpy_bridge, "
            "pysparselp_tpu_torch.checkpoint, "
            "pysparselp_tpu_torch.benchmarks, "
            "pysparselp_tpu_torch.utils.debug, "
            "pysparselp_tpu_torch.utils.instrumentation, "
            "pysparselp_tpu_torch.utils.timers, "
            "pysparselp_tpu_torch.utils.xorshift, "
            "chip_smoke; "
            "sys.path.insert(0, 'scripts'); import probe_csr_spmv, "
            "probe_bsr_spmv, profile_port, profile_mesh, time_presolve, "
            "compare_kernels, probe_dca_sweep, probe_csr_batch_orders, "
            "probe_trace_loss, profile_dca_blocked; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('pysparselp_tpu.') or "
            "m == 'pysparselp_tpu' for m in sys.modules), 'JAX package'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_no_port_file_imports_jax():
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "import jax" not in text, name
                assert "from jax" not in text, name
    for script in ("chip_smoke.py", os.path.join("scripts", "profile_port.py"),
                   os.path.join("scripts", "probe_csr_spmv.py"),
                   os.path.join("scripts", "probe_bsr_spmv.py"),
                   os.path.join("scripts", "profile_mesh.py"),
                   os.path.join("scripts", "time_presolve.py"),
                   os.path.join("scripts", "compare_kernels.py"),
                   os.path.join("scripts", "probe_dca_sweep.py"),
                   os.path.join("scripts", "probe_csr_batch_orders.py"),
                   os.path.join("scripts", "probe_trace_loss.py"),
                   os.path.join("scripts", "profile_dca_blocked.py")):
        with open(os.path.join(REPO, script)) as f:
            text = f.read()
        assert "import jax" not in text and "pysparselp_tpu." not in (
            text.replace("pysparselp_tpu/", "")), script


def test_device_and_dtype_resolution():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_dtype(None, "cpu") == torch.float64
    assert resolve_dtype(None, "cuda") == torch.float32
    assert resolve_dtype(np.float32, "cpu") == torch.float32
    with pytest.raises(ValueError):
        resolve_dtype(np.float16, "cpu")


def _tiny_lp():
    lp = SparseLP()
    x = lp.add_variables_array(4, 0, 1, costs=np.array([1.0, -1, 2, -2]))
    lp.add_inequality_constraints(x[None, :], np.ones((1, 4)),
                                  upper_bounds=np.array([1.5]))
    return lp


def test_default_device_is_cuda():
    lp = _tiny_lp()
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        lp.solve(method="chambolle_pock_ppd", nb_iter=10)


@pytest.mark.parametrize("method", ["admm_blocks", "dual_gradient_ascent",
                                    "dual_coordinate_ascent"])
def test_mesh_with_dual_and_block_methods_names_m9(method):
    """``mesh=`` with these methods (ROADMAP M9, once refused here) runs:
    on a one-rank gloo mesh the tiny LP's solve equals the JAX package's
    ``lp.solve(mesh=...)`` on the conftest's 8 CPU devices within 1e-9
    (float64, 10 iterations), and a ``mesh`` that is not the port's
    ``Mesh`` is refused with a ``TypeError``."""
    from pysparselp_tpu.modeling import SparseLP as JaxLP
    from pysparselp_tpu.parallel.mesh import default_mesh
    from torch_port_helpers import one_rank_mesh

    run = dict(method=method, nb_iter=10, nb_iter_plot=10, dtype=np.float64)
    with one_rank_mesh() as mesh:
        got, _ = _tiny_lp().solve(device="cpu", mesh=mesh, **run)
    jlp = JaxLP()
    x = jlp.add_variables_array(4, 0, 1, costs=np.array([1.0, -1, 2, -2]))
    jlp.add_inequality_constraints(x[None, :], np.ones((1, 4)),
                                   upper_bounds=np.array([1.5]))
    want, _ = jlp.solve(mesh=default_mesh(8), **run)
    np.testing.assert_allclose(got, want, atol=1e-9)
    with pytest.raises(TypeError, match="Mesh"):
        _tiny_lp().solve(method=method, nb_iter=10, device="cpu",
                         mesh=object())


@pytest.mark.parametrize("kwargs", [dict(mesh=object())])
def test_unported_options_name_their_roadmap_item(kwargs):
    """``mesh=`` is ported: anything but the port's ``Mesh`` is refused
    with a ``TypeError`` that names the class to pass."""
    with pytest.raises(TypeError,
                       match=r"pysparselp_tpu_torch\.parallel\.mesh\.Mesh"):
        _tiny_lp().solve(method="chambolle_pock_ppd", nb_iter=10,
                         device="cpu", **kwargs)


@pytest.mark.parametrize("permute", ["rcm", True])
def test_rcm_permute_solves_like_unpermuted(permute):
    """The RCM layout presolve runs on the CPU and returns x in the
    original column order: the same x as no permutation."""
    run = dict(method="chambolle_pock_ppd", nb_iter=2000, nb_iter_plot=1000,
               device="cpu")
    x_plain, _ = _tiny_lp().solve(permute=False, **run)
    x_rcm, _ = _tiny_lp().solve(permute=permute, **run)
    np.testing.assert_allclose(x_rcm, x_plain, rtol=1e-9, atol=1e-12)


def test_tiny_solve_on_cpu():
    lp = _tiny_lp()
    x, _ = lp.solve(method="chambolle_pock_ppd", nb_iter=4000,
                    nb_iter_plot=1000, device="cpu")
    assert lp.max_constraint_violation(x) < 1e-6
    np.testing.assert_allclose(lp.cost(x), -2.5, atol=1e-6)
