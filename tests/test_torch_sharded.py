"""The row-sharded CP-PPD port (``pysparselp_tpu_torch.parallel``) against the
JAX package's mesh solver (``pysparselp_tpu/parallel/sharded_cp.py``), on the
CPU in float64.

The port's ranks are processes over ``torch.distributed`` with gloo
(``parallel.mesh.spawn``); their bodies live in the jax-free
``torch_sharded_workers``, and each world size (1, 2, 4) is spawned once per
module, in the background while JAX computes the references here on the
conftest's 8 virtual CPU devices.  JAX is imported inside the tests: the card
machine, which runs this file's ``cuda`` cases (``python -m pytest
--noconftest -m cuda``), has none.
"""

import concurrent.futures
import copy
import functools
import itertools

import numpy as np
import pytest
import scipy.sparse
import torch

import torch_sharded_workers as workers
from pysparselp_tpu_torch import problem as ppr
from pysparselp_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference
from pysparselp_tpu_torch.parallel import sharded_dia as psd
from pysparselp_tpu_torch.parallel.mesh import Mesh, spawn
from pysparselp_tpu_torch.solvers.chambolle_pock import _fold_one_sided
from pysparselp_tpu_torch.utils.convert import sharded_from_jax
from torch_port_helpers import cuda_or_skip

torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4)
# solver cases: (build, kwargs); the same arguments go to both packages
SOLVES = {
    "random_general": ("random", dict(permute=False, nb_max_iter=300,
                                      nb_iter_plot=300)),
    "potts16_align": ("potts16", dict(permute="align", nb_max_iter=300,
                                      nb_iter_plot=150, force_integer=True)),
    "eqineq_align": ("eqineq", dict(permute="align", nb_max_iter=200,
                                    nb_iter_plot=100)),
}
DISPATCH = dict(nb_iter=500, nb_iter_plot=500, dtype=np.float64)
RESTART = dict(permute=False, nb_max_iter=3000, nb_iter_plot=500,
               restart="average")
STOP = dict(nb_iter=8000, nb_iter_plot=400, stop_tol=5e-2)
RESUME_STEPS = 200


def _random_lp():
    """The LP of ``tests/test_sharding.py``'s fixture (JAX SparseLP)."""
    from pysparselp_tpu.utils.random_lp import generate_random_lp

    lp, _ = generate_random_lp(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2,
                               seed=10)
    lp2 = copy.deepcopy(lp)
    lp2.convert_to_one_sided_inequality_system()
    return lp2


def _lp_args(lp):
    return (lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
            lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper,
            lp.lower_bounds, lp.upper_bounds)


def _potts16_lp(port=False):
    if port:
        from pysparselp_tpu_torch.examples.potts import build_linear_program
    else:
        from pysparselp_tpu.examples.potts import build_linear_program
    return build_linear_program(16, 0.5, 500)[0]


def _potts16_args(port=False):
    lp = _potts16_lp(port)
    return (lp.costsvector, None, None, lp.a_inequalities.tocsr(),
            lp.b_lower, lp.b_upper, lp.lower_bounds, lp.upper_bounds)


def _eqineq_args():
    """The eq+ineq system of ``test_sharding.py``'s align case."""
    rng = np.random.RandomState(5)
    n = 60
    a_eq = scipy.sparse.random(10, n, density=0.15, random_state=rng,
                               format="csr")
    a_in = scipy.sparse.random(40, n, density=0.12, random_state=rng,
                               format="csr")
    x_feas = rng.rand(n)
    c = rng.randn(n)
    return (c, a_eq, a_eq @ x_feas, a_in, None, a_in @ x_feas + 0.5,
            np.zeros(n), np.ones(n))


@functools.lru_cache(maxsize=None)
def _args(build):
    if build == "random":
        return _lp_args(_random_lp())
    if build == "potts16":
        return _potts16_args()
    return _eqineq_args()


def _aligned(args):
    """The one-sided, anchor-aligned host system of the solver arguments
    (the dict ``apply_align_embedding`` returns), as the mesh solver
    builds it."""
    c, a_eq, beq, a_ineq, bl, bu, lb, ub = args
    a_one, b_one = _fold_one_sided(a_ineq, bl, bu)
    sys_ = dict(a_eq=a_eq, beq=beq, a_ineq=a_one, b_ineq=b_one, c=c, lb=lb,
                ub=ub, x0=None, x30=None, y_eq0=None, y_ineq0=None)
    sys_ = ppr.apply_align_embedding(ppr.anchor_align([a_eq, a_one]),
                                     sys_)[0]
    return sys_


def _jax_mesh(ndev):
    from pysparselp_tpu.parallel.mesh import default_mesh

    return default_mesh(ndev)


# JAX compiles its eq+ineq align solve (63 and 132 diagonals, K5 unrolled
# in interpret mode) in ~45 s per mesh size, so its reference runs on one
# mesh; test_sharding.py holds the JAX solver's device-count invariance
JAX_MESH = {"eqineq_align": 4}


@functools.lru_cache(maxsize=None)
def _jax_solve(name, ndev):
    from pysparselp_tpu.parallel.sharded_cp import chambolle_pock_ppd_sharded

    ndev = JAX_MESH.get(name, ndev)
    build, kw = SOLVES[name]
    out = chambolle_pock_ppd_sharded(*_args(build), _jax_mesh(ndev),
                                     dtype=np.float64, **kw)
    return out if kw.get("force_integer") else (out, None)


def _jax_resume_inputs():
    """JAX's per-shard DIA data for aligned Potts-16 on 8 devices, its state
    after RESUME_STEPS iterations and after twice that, as numpy."""
    import jax

    from pysparselp_tpu.parallel.sharded_cp import (build_sharded_cp_data,
                                                    sharded_cp_chunk)

    sys_ = _aligned(_args("potts16"))
    mesh = _jax_mesh(8)
    data, state = build_sharded_cp_data(
        sys_["c"], None, None, sys_["a_ineq"], sys_["b_ineq"], sys_["lb"],
        sys_["ub"], mesh, dtype=np.float64, operator="dia")
    half, _ = sharded_cp_chunk(data, state, mesh, RESUME_STEPS)
    full, _ = sharded_cp_chunk(data, half, mesh, RESUME_STEPS)

    def host(tree):
        return jax.tree.map(np.asarray, tree)

    return host(data), host(half), host(full)


@pytest.fixture(scope="module")
def resume_inputs():
    return _jax_resume_inputs()


def _cases(world_size, resume):
    cases = [(name, "solve", (_args(build), dict(kw, dtype=np.float64)))
             for name, (build, kw) in SOLVES.items()]
    if world_size == 4:
        cases += [
            ("dispatch", "dispatch", (_args("random"), DISPATCH)),
            ("resume", "resume", (resume[0], resume[1], RESUME_STEPS)),
            ("mesh_checks", "mesh_checks", ()),
        ]
    if world_size == 2:
        cases += [
            ("restart", "solve", (_args("random"),
                                  dict(RESTART, dtype=np.float64))),
            ("stop_tol", "dispatch", (_args("random"),
                                      dict(STOP, dtype=np.float64))),
            ("mesh_checks", "mesh_checks", ()),
        ]
    return cases


@pytest.fixture(scope="module")
def port_runs(resume_inputs):
    """``{world_size: future of {case: result}}``: one gloo spawn per world
    size, all started at once."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLD_SIZES))
    runs = {n: pool.submit(spawn, workers.run_cases, n, "gloo", "cpu",
                           _cases(n, resume_inputs))
            for n in WORLD_SIZES}
    yield runs
    pool.shutdown(wait=True)


def _port(port_runs, world_size, case):
    return port_runs[world_size].result()[case]


# ----------------------------------------------------------------------
# (a) the shard build, (b) the per-shard products: no processes needed
# ----------------------------------------------------------------------

def _systems(build):
    sys_ = _aligned(_args(build))
    return [(sys_[a], sys_[b]) for a, b in (("a_eq", "beq"),
                                            ("a_ineq", "b_ineq"))
            if sys_[a] is not None]


def _port_global(a, b, ndev):
    """The port's shards of ``A x <= b`` joined back: offsets, forward
    planes, the windows' transposed planes over all n columns, b, mask."""
    m, n = a.shape
    shards = [psd.build_system_dia(a, b, ndev, r) for r in range(ndev)]
    rows_loc = shards[0][1]
    offsets = shards[0][0]["dia_offs"].astype(np.int64)
    win = np.zeros((offsets.size, n))
    for r, (s, rl, m_pad) in enumerate(shards):
        assert (rl, m_pad) == (rows_loc, rows_loc * ndev)
        lo = r * rows_loc
        np.testing.assert_array_equal(s["dia_offs"] - lo, offsets)
        np.testing.assert_array_equal(s["dia_offs_t"],
                                      s["dia_wlo"] - lo - offsets)
        w = s["dia_vals_t"].shape[1]
        assert w <= n and s["dia_wlo"] + w <= n
        win[:, s["dia_wlo"]:s["dia_wlo"] + w] += s["dia_vals_t"]
    fwd = np.concatenate([s["dia_vals"] for s, _, _ in shards], axis=1)
    return (offsets, fwd[:, :m], win,
            np.concatenate([s["b"] for s, _, _ in shards]),
            np.concatenate([s["row_mask"] for s, _, _ in shards]))


def _jax_global(a, b, ndev):
    """The JAX shards, kernel padding and 128-row rounding stripped."""
    from pysparselp_tpu.parallel.sharded_dia import build_system_dia

    m, n = a.shape
    data, rows_loc, m_pad = build_system_dia(a, b, ndev)
    ndiag = data["dia_offs"].shape[1]
    offsets = data["dia_offs"][0].astype(np.int64)
    win = np.zeros((ndiag, n))
    for d in range(ndev):
        wlo = int(data["dia_wlo"][d, 0])
        width = min(data["dia_vals_t"].shape[2], n - wlo)
        win[:, wlo:wlo + width] += data["dia_vals_t"][d][:ndiag, :width]
    fwd = np.concatenate([data["dia_vals"][d][:ndiag, :rows_loc]
                          for d in range(ndev)], axis=1)
    return (offsets, fwd[:, :m], win, data["b"].reshape(-1),
            data["row_mask"].reshape(-1))


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("build", ["potts16", "eqineq"])
def test_shard_build_matches_jax(build, ndev):
    """(a) Offsets, forward planes, transpose windows, b and the row mask
    of the port's shards equal the JAX shards' without their padding."""
    for a, b in _systems(build):
        m = a.shape[0]
        got, want = _port_global(a, b, ndev), _jax_global(a, b, ndev)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_array_equal(g[:m], w[:m])
            assert not np.any(g[m:]) and not np.any(w[m:])


@pytest.mark.parametrize("build,ndev", [
    ("potts16", 1), ("potts16", 2), ("potts16", 4), ("potts16", 8),
    ("eqineq", 4)])
def test_local_products_match_jax(build, ndev):
    """(b) The port's per-shard products (H-DIA's twin) on data carried by
    ``sharded_from_jax`` against JAX's per-shard products (K5 in interpret
    mode), joined over the shards, float64.  The eq+ineq system runs on one
    shard count: JAX compiles its 132-diagonal K5 in ~30 s per shape."""
    import jax.numpy as jnp

    from pysparselp_tpu.parallel import sharded_dia as jsd
    from pysparselp_tpu.parallel.sharded_cp import build_sharded_cp_data

    sys_ = _aligned(_args(build))
    n = len(sys_["c"])
    data_j, state_j = build_sharded_cp_data(
        sys_["c"], sys_["a_eq"], sys_["beq"], sys_["a_ineq"], sys_["b_ineq"],
        sys_["lb"], sys_["ub"], _jax_mesh(ndev), dtype=np.float64,
        operator="dia")
    host = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in data_j.items()}
    ports = [sharded_from_jax(host, {k: np.asarray(v)
                                     for k, v in state_j.items()}, ndev, r)[0]
             for r in range(ndev)]
    rng = np.random.RandomState(ndev)
    x = rng.randn(n)
    for name in ("eq", "ineq"):
        if name not in data_j:
            continue
        m = data_j[name + "_m"]
        y = rng.randn(m)
        sys_j = data_j[name]
        rows_j = sys_j["b"].shape[1]
        y_j = np.zeros(rows_j * ndev)
        y_j[:m] = y
        y_j = y_j.reshape(ndev, rows_j)
        fwd_j, t_j = [], np.zeros(n)
        for d in range(ndev):
            loc = {k: v[d] for k, v in sys_j.items()}
            fwd_j.append(np.asarray(jsd.local_matvec_dia(
                loc, jnp.asarray(x), n)))
            t_j += np.asarray(jsd.local_rmatvec_dia(
                loc, jnp.asarray(y_j[d]), n))
        fwd_p, t_p = [], torch.zeros(n, dtype=torch.float64)
        for r, d_p in enumerate(ports):
            loc = d_p[name]
            rows_loc = loc["b"].shape[0]
            y_loc = np.zeros(rows_loc)
            part = y[r * rows_loc:(r + 1) * rows_loc]
            y_loc[:part.size] = part
            fwd_p.append(psd.local_matvec_dia(
                loc, torch.as_tensor(x), n).numpy())
            psd.local_rmatvec_dia(loc, torch.as_tensor(y_loc), n, out=t_p)
        want_f = np.concatenate(fwd_j)[:m]
        np.testing.assert_allclose(np.concatenate(fwd_p)[:m], want_f,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(want_f).max())
        np.testing.assert_allclose(t_p.numpy(), t_j, rtol=1e-12,
                                   atol=1e-12 * np.abs(t_j).max())


# ----------------------------------------------------------------------
# (c)-(h) gloo solves on 1, 2 and 4 ranks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_gloo_solve_matches_jax(port_runs, name, world_size):
    """(c) The port's mesh solve on ``world_size`` gloo ranks equals JAX's
    ``chambolle_pock_ppd_sharded`` on as many devices (the eq+ineq case: on
    4, see JAX_MESH) to atol 1e-9, in the layout the case asks for;
    ``force_integer``'s best iterate too."""
    got = _port(port_runs, world_size, name)
    want_x, want_best = _jax_solve(name, world_size)
    np.testing.assert_allclose(got["x"], want_x, atol=1e-9)
    if want_best is None:
        assert got["best"] is None
    else:
        np.testing.assert_array_equal(got["best"], want_best)
    kw = SOLVES[name][1]
    assert got["info"]["operator"] == ("dia" if kw["permute"] == "align"
                                       else "tiles")
    assert got["info"]["ranks"] == world_size
    assert [c[0] for c in got["checkpoints"]] == list(range(
        kw["nb_iter_plot"], kw["nb_max_iter"] + 1, kw["nb_iter_plot"]))


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_device_count_invariance(port_runs, name):
    """(d) One rank and four ranks give the same solve (atol 1e-9), and the
    same checkpoint metrics."""
    one = _port(port_runs, 1, name)
    four = _port(port_runs, 4, name)
    np.testing.assert_allclose(four["x"], one["x"], atol=1e-9)
    np.testing.assert_allclose(
        np.array([c[1:] for c in four["checkpoints"]], np.float64),
        np.array([c[1:] for c in one["checkpoints"]], np.float64),
        rtol=1e-9, atol=1e-9)


def test_solve_dispatch_matches_jax(port_runs):
    """(e) ``lp.solve(mesh=...)`` routes to the row-sharded solver: the
    port on 4 ranks equals JAX's ``lp.solve(mesh=default_mesh(8))``, one
    checkpoint recorded (``test_sharding.py::test_solve_dispatch_with_mesh``)."""
    got = _port(port_runs, 4, "dispatch")
    lp = _random_lp()
    x8, _ = lp.solve(method="chambolle_pock_ppd", mesh=_jax_mesh(8),
                     **DISPATCH)
    np.testing.assert_allclose(got["x"], x8, atol=1e-10)
    assert len(got["itrn"]) == len(lp.itrn_curve) == 1
    np.testing.assert_allclose(got["pobj"], lp.pobj_curve, rtol=1e-9)


def test_sharded_restart_reaches_simplex(port_runs):
    """(f) ``restart="average"`` on 2 ranks meets
    ``test_sharded_restart_accelerates``' bar: mean |x - simplex| < 1e-2."""
    got = _port(port_runs, 2, "restart")
    ref, _ = _random_lp().solve(method="scipy_simplex")
    assert np.mean(np.abs(got["x"] - ref)) < 1e-2


def test_resume_from_jax_sharded_state(port_runs, resume_inputs):
    """(g) A JAX sharded state (8 shards of 128-row height) carried to 4
    port ranks by ``sharded_from_jax`` resumes where JAX goes on: x after
    another RESUME_STEPS iterations equals JAX's (atol 1e-10), and rank 0's
    duals equal JAX's rows of them."""
    got = _port(port_runs, 4, "resume")
    _data, _half, full = resume_inputs
    np.testing.assert_allclose(got["x"], full["x"], atol=1e-10)
    lo, hi = got["rows"]
    np.testing.assert_allclose(got["y_ineq"],
                               full["y_ineq"].reshape(-1)[lo:hi], atol=1e-10)


def test_stop_tol_ends_the_mesh_solve_early(port_runs):
    """(g) ``stop_tol`` reaches the mesh solve through ``lp.solve``."""
    got = _port(port_runs, 2, "stop_tol")
    assert got["itrn"][-1] < STOP["nb_iter"]
    assert got["itrn"] == list(range(400, got["itrn"][-1] + 1, 400))


@pytest.mark.parametrize("world_size", [2, 4])
def test_mesh_collectives(port_runs, world_size):
    """psum and pmax over gloo on 0-d and 1-D tensors, counted per
    (op, numel); the input is left as it was."""
    got = _port(port_runs, world_size, "mesh_checks")
    n = world_size
    assert got["size"] == n and got["backend"] == "gloo"
    assert got["psum0"] == n * (n + 1) / 2 and got["pmax0"] == n
    assert got["shape0"] == () and got["unchanged"] == 1.0
    np.testing.assert_array_equal(got["psum1"], np.arange(3) * n * (n + 1) / 2)
    np.testing.assert_array_equal(got["pmax1"], -np.arange(3) * 1.0)
    assert got["calls"] == {("sum", 1): 2, ("max", 1): 1, ("sum", 3): 1,
                            ("max", 3): 1}


def test_no_silent_cpu(port_runs):
    """(h) A CUDA mesh on a machine without CUDA raises instead of running
    on the CPU, and a ``device=`` that disagrees with the mesh raises."""
    errors = _port(port_runs, 2, "mesh_checks")["errors"]
    if not torch.cuda.is_available():
        assert "cuda" in errors["cuda_mesh"]
    assert "disagrees with mesh.device" in errors["device"]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        Mesh(device="cpu")


def test_spawn_reraises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        spawn(workers.fail_on_rank_one, 2, "gloo", "cpu")
    assert "rank one fails on purpose" in str(err.value)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_kernel_on_shards_cuda(dtype):
    """H-DIA against its twin on every shard of aligned Potts-16 and of
    the aligned eq+ineq system over 4 and 8 ranks, forward and window.
    The eq+ineq shards are shorter than their diagonals' spread, so many
    window offsets fall outside ``(-w, rows_loc)``: whole diagonals that
    miss the shard, which K5 clamps and H-DIA reads as zeros."""
    dev = cuda_or_skip()
    potts, eqineq = _aligned(_potts16_args(port=True)), _aligned(
        _eqineq_args())
    systems = [(potts["a_ineq"], potts["b_ineq"]),
               (eqineq["a_eq"], eqineq["beq"]),
               (eqineq["a_ineq"], eqineq["b_ineq"])]
    rng = np.random.RandomState(0)
    outside = 0
    for (a, b), ndev in itertools.product(systems, (4, 8)):
        for r in range(ndev):
            s, rows_loc, _ = psd.build_system_dia(a, b, ndev, r)
            w = s["dia_vals_t"].shape[1]
            outside += int(np.sum((s["dia_offs_t"] <= -w)
                                  | (s["dia_offs_t"] >= rows_loc)))
            for vals, offs, n_in, n_out in (
                    (s["dia_vals"], s["dia_offs"], a.shape[1], rows_loc),
                    (s["dia_vals_t"], s["dia_offs_t"], rows_loc, w)):
                v = torch.as_tensor(vals, dtype=dtype, device=dev)
                o = torch.as_tensor(offs, device=dev)
                x = torch.as_tensor(rng.randn(n_in), dtype=dtype, device=dev)
                got = dia_spmv(v, o, x, n_out)
                want = dia_spmv_reference(v.cpu(), o.cpu(), x.cpu(), n_out)
                rtol = 1e-5 if dtype == torch.float32 else 1e-12
                scale = max(1.0, float(want.abs().max()))
                assert float((got.cpu() - want).abs().max()) <= rtol * scale
    assert outside > 0


@pytest.mark.cuda
def test_gloo_collectives_on_cuda_tensors_cuda():
    """Gloo reduces CUDA tensors through the host: SUM and MAX, 0-d and
    1-D, on 2 ranks that share the card."""
    cuda_or_skip()
    got = spawn(workers.run_cases, 2, "gloo", "cuda",
                [("checks", "mesh_checks", ())])["checks"]
    assert got["psum0"] == 3 and got["pmax0"] == 2 and got["shape0"] == ()
    np.testing.assert_array_equal(got["psum1"], np.arange(3) * 3.0)
    np.testing.assert_array_equal(got["pmax1"], -np.arange(3) * 1.0)


@pytest.mark.cuda
def test_nccl_one_rank_solve_cuda():
    """A one-rank NCCL mesh solve on the card (H-DIA shards, float64)
    equals the one-rank gloo solve on the CPU (the twins)."""
    cuda_or_skip()
    args = _potts16_args(port=True)
    case = [("potts", "solve", (args, dict(permute="align", nb_max_iter=300,
                                           nb_iter_plot=150,
                                           dtype=np.float64)))]
    gpu = spawn(workers.run_cases, 1, "nccl", "cuda", case)["potts"]
    cpu = spawn(workers.run_cases, 1, "gloo", "cpu", case)["potts"]
    assert gpu["info"]["operator"] == "dia"
    np.testing.assert_allclose(gpu["x"], cpu["x"], atol=1e-9)
