"""The port's mesh solvers beside CP (``pysparselp_tpu_torch.parallel``:
``sharded_mehrotra``, ``sharded_admm``, ``sharded_dga``, ``sharded_dca``
and ``admm_blocks``' block sharding) against the JAX package's sharded
solvers on the conftest's 8 virtual CPU devices and against the port's
one-device solvers, on the CPU in float64.

The cases mirror ``tests/test_sharded_mehrotra.py``,
``tests/test_sharded_admm.py`` and the DGA/DCA cases of
``tests/test_sharding.py``.  The port's ranks are processes over
``torch.distributed`` with gloo (``parallel.mesh.spawn``), their bodies in
the jax-free ``torch_sharded_workers``; each world size (1, 2, 4) is
spawned once per module, in the background while JAX computes the
references here.  Each test states its tolerance.
"""

import concurrent.futures
import copy
import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import torch_sharded_workers as workers
from pysparselp_tpu_torch.parallel.mesh import spawn
from pysparselp_tpu_torch.solvers.dual_ascent import _color_rows

torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4)
F64 = dict(dtype=np.float64)
# LPs: the JAX tests' fixtures
RANDOM_ADMM = ("random", dict(nbvar=30, n_eq=3, n_ineq=28, sparsity=0.25,
                              seed=4))
RANDOM_DUAL = ("random", dict(nbvar=30, n_eq=2, n_ineq=30, sparsity=0.2,
                              seed=10))
ASSIGN = ("assign", 5, 5)
BLOCKY = ("blocky",)
# the interior point's standard forms (test_sharded_mehrotra.py)
IPM = {"ipm_dense": (8, 30, 7, {}), "ipm_seed3": (8, 30, 3, {}),
       "ipm_cg": (6, 25, 11, dict(dense_threshold=0)),
       "ipm_cg_dense": (6, 25, 11, {})}
SOLVES = {
    "mehrotra_dispatch": (ASSIGN, dict(method="mehrotra", nb_iter=40, **F64)),
    "admm2": (RANDOM_ADMM, dict(method="admm2", nb_iter=600,
                                nb_iter_plot=300, **F64)),
    "admm2_cg": (RANDOM_ADMM, dict(method="admm2", nb_iter=120,
                                   nb_iter_plot=60, dense_threshold=0, **F64)),
    "admm2_dense": (RANDOM_ADMM, dict(method="admm2", nb_iter=120,
                                      nb_iter_plot=60, **F64)),
    "admm": (RANDOM_ADMM, dict(method="admm", nb_iter=400, nb_iter_plot=200,
                               **F64)),
    "admm_200": (RANDOM_ADMM, dict(method="admm", nb_iter=200,
                                   nb_iter_plot=100, **F64)),
    "dga_1": (RANDOM_DUAL, dict(method="dual_gradient_ascent", nb_iter=1,
                                nb_iter_plot=1, **F64)),
    "dga_2000": (RANDOM_DUAL, dict(method="dual_gradient_ascent",
                                   nb_iter=2000, nb_iter_plot=2000, **F64)),
    "dca_8": (RANDOM_DUAL, dict(method="dual_coordinate_ascent", nb_iter=8,
                                nb_iter_plot=1, **F64)),
    "admm_blocks": (BLOCKY, dict(method="admm_blocks", nb_iter=200,
                                 nb_iter_plot=100, **F64)),
}
# cases run on one world size only
ONLY = {
    "admm2_opt": (4, RANDOM_ADMM, dict(method="admm2", nb_iter=3000,
                                       nb_iter_plot=1000, adaptive_rho=True,
                                       **F64)),
    "cp_options": (4, RANDOM_ADMM, dict(
        method="chambolle_pock_ppd", nb_iter=400, nb_iter_plot=200,
        restart="average", restart_period=100, save_problem=False,
        theta=1.0, stop_tol=1e-12, **F64)),
}


def _zero_merge_system(owner):
    """A hand-made colour-merge state, one colour group of four rows on
    six columns: row 0 stores 1 at column 1 and a zero at column 2, rows
    1-3 one 1 each at columns 3-5 and a padding slot at column 0 (with
    ``owner``, row 3 stores 1 at column 0 instead of its padding).  c̄ is
    -0 at columns 0 and 2.  Rows 0 and 1 step (row 1 by a negative step,
    so its padding adds -0 at column 0), rows 2 and 3 are inactive (their
    padding adds +0).  One device turns c̄[0] and c̄[2] to +0; on 2 and 4
    ranks the first rank to touch column 0 is row 1's."""
    rows = [0, 0, 1, 2, 3] + ([3] if owner else [])
    cols = [1, 2, 3, 4, 5] + ([0] if owner else [])
    vals = [1.0, 0.0, 1.0, 1.0, 1.0] + ([1.0] if owner else [])
    return dict(a=scipy.sparse.csr_matrix((vals, (rows, cols)),
                                          shape=(4, 6)),
                b=np.full(4, 0.5), lb=np.zeros(6), ub=np.ones(6),
                y=np.array([1.0, 2.0, 1.0, 1.0]),
                c_bar=np.array([-0.0, -0.5, -0.0, 0.75, 0.25, -0.25]),
                active=np.array([True, True, False, False]))


# (owner, dtype, project) of the colour merge's cases
DCA_MERGE = {f"dca_merge_{o}_{d}_{p}": (o == "owner", d, p == "ineq")
             for o in ("padding", "owner") for d in ("float64", "float32")
             for p in ("eq", "ineq")}


def _standard_form(m=8, n=30, seed=7):
    """``test_sharded_mehrotra.py``'s feasible bounded standard form."""
    rng = np.random.RandomState(seed)
    a = rng.rand(m, n) * (rng.rand(m, n) < 0.6)
    a[:, :m] += np.eye(m)
    x_feas = rng.rand(n) + 0.5
    return a, a @ x_feas, rng.rand(n) + 0.1


def _cases(world_size):
    cases = [(name, "mpc", (*_standard_form(m, n, seed),
                            dict(kw, max_iter=50, **F64)))
             for name, (m, n, seed, kw) in IPM.items()]
    cases += [(name, "lp_solve", spec_kw) for name, spec_kw in SOLVES.items()]
    cases += [(name, "lp_solve", (spec, kw))
              for name, (ws, spec, kw) in ONLY.items() if ws == world_size]
    cases += [(name, "dca_merge", (_zero_merge_system(owner), dt, proj, 4))
              for name, (owner, dt, proj) in DCA_MERGE.items()]
    if world_size > 1:
        cases += [("dga_dia", "dga_dia", (RANDOM_DUAL, dict(nb_max_iter=1,
                                                            **F64))),
                  ("admm_layouts", "admm_layouts", (RANDOM_ADMM, 50))]
    return cases


@pytest.fixture(scope="module")
def port_runs():
    """``{world_size: future of {case: result}}``: one gloo spawn per world
    size, all started at once."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLD_SIZES))
    runs = {n: pool.submit(spawn, workers.run_cases, n, "gloo", "cpu",
                           _cases(n))
            for n in WORLD_SIZES}
    yield runs
    pool.shutdown(wait=True)


def _port(port_runs, world_size, case):
    return port_runs[world_size].result()[case]


def _jax_mesh(ndev):
    from pysparselp_tpu.parallel.mesh import default_mesh

    return default_mesh(ndev)


def _jax_lp(spec):
    """The JAX package's LP of a worker spec."""
    import pysparselp_tpu.modeling as jm
    from pysparselp_tpu.utils.random_lp import generate_random_lp

    if spec[0] == "random":
        lp, _ = generate_random_lp(**spec[1])
        lp = copy.deepcopy(lp)
        lp.convert_to_one_sided_inequality_system()
        return lp
    if spec[0] == "assign":
        _, n, seed = spec
        cost = np.random.RandomState(seed).rand(n, n)
        lp = jm.SparseLP()
        x = lp.add_variables_array(cost.shape, 0, 1, costs=cost)
        lp.add_equality_constraints(x, np.ones_like(cost), b=np.ones(n))
        return lp
    np.random.seed(5)
    lp = jm.SparseLP()
    lp.add_variables_array(40, 0, 1, costs=np.random.randn(40))
    for _k in range(4):
        cols = np.zeros((5, 3), dtype=int)
        for r in range(5):
            cols[r] = np.random.choice(40, 3, replace=False)
        lp.add_inequality_constraints(cols, np.ones((5, 3)),
                                      lower_bounds=None, upper_bounds=2.0)
    return lp


@functools.lru_cache(maxsize=None)
def _jax_solve(name, ndev=8):
    """JAX's ``lp.solve(mesh=default_mesh(ndev))`` of a case: x and the
    dual curve."""
    spec, kw = SOLVES[name]
    lp = _jax_lp(spec)
    x, _ = lp.solve(mesh=_jax_mesh(ndev), **kw)
    return x, list(lp.dobj_curve)


@functools.lru_cache(maxsize=None)
def _one_device(name):
    """The port's one-device solve of a case (on the CPU): x and the dual
    curve."""
    spec, kw = SOLVES[name]
    lp = workers.make_lp(spec)
    x, _ = lp.solve(device="cpu", **kw)
    return x, list(lp.dobj_curve)


@functools.lru_cache(maxsize=None)
def _jax_mpc(name, ndev=8):
    from pysparselp_tpu.parallel.sharded_mehrotra import mpc_sol_sharded

    m, n, seed, kw = IPM[name]
    return mpc_sol_sharded(*_standard_form(m, n, seed), _jax_mesh(ndev),
                           max_iter=50, dtype=np.float64, **kw)


@functools.lru_cache(maxsize=None)
def _one_device_mpc(name):
    from pysparselp_tpu_torch.solvers.mehrotra import mpc_sol

    m, n, seed, kw = IPM[name]
    return mpc_sol(*_standard_form(m, n, seed), max_iter=50,
                   dtype=np.float64, device="cpu", **kw)


# ----------------------------------------------------------------------
# the column-sharded interior point (test_sharded_mehrotra.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sharded_mehrotra_matches_jax_and_one_device(port_runs, world_size):
    """x and y within 1e-9 and f within 1e-9 of JAX's
    ``mpc_sol_sharded`` on 8 devices and of the port's one-device
    ``mpc_sol`` (float64, dense regime)."""
    got = _port(port_runs, world_size, "ipm_dense")
    assert got["info"]["regime"] == "dense"
    for f, x, y, _s, niter in (_jax_mpc("ipm_dense"),
                               _one_device_mpc("ipm_dense")):
        np.testing.assert_allclose(got["x"], x, atol=1e-9)
        np.testing.assert_allclose(got["y"], y, atol=1e-9)
        assert abs(got["f"] - f) < 1e-9
        assert got["niter"] == niter


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sharded_mehrotra_device_count_invariance(port_runs, world_size):
    """Every rank count gives the one-device x within 1e-8, and JAX's on as
    many devices within 1e-8."""
    got = _port(port_runs, world_size, "ipm_seed3")
    np.testing.assert_allclose(got["x"], _one_device_mpc("ipm_seed3")[1],
                               atol=1e-8)
    np.testing.assert_allclose(got["x"], _jax_mpc("ipm_seed3", world_size)[1],
                               atol=1e-8)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sharded_mehrotra_cg_regime(port_runs, world_size):
    """``dense_threshold=0`` forces the CG regime (one psum per CG step,
    H-CSR's twin on each rank's columns): x within 1e-6 of the dense
    regime's and of JAX's CG regime."""
    cg = _port(port_runs, world_size, "ipm_cg")
    dense = _port(port_runs, world_size, "ipm_cg_dense")
    assert (cg["info"]["regime"], dense["info"]["regime"]) == ("cg", "dense")
    np.testing.assert_allclose(cg["x"], dense["x"], atol=1e-6)
    np.testing.assert_allclose(cg["x"], _jax_mpc("ipm_cg")[1], atol=1e-6)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_mehrotra_mesh_dispatch(port_runs, world_size):
    """``lp.solve(method="mehrotra", mesh=...)`` routes to the sharded
    interior point: x within 1e-8 of the one-device port's and of JAX's
    mesh solve."""
    got = _port(port_runs, world_size, "mehrotra_dispatch")
    for x, _ in (_one_device("mehrotra_dispatch"),
                 _jax_solve("mehrotra_dispatch")):
        np.testing.assert_allclose(got["x"], x, atol=1e-8)


# ----------------------------------------------------------------------
# the row-sharded ADMM solvers (test_sharded_admm.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("name", ["admm2", "admm"])
def test_admm_mesh_matches_jax_and_one_device(port_runs, name, world_size):
    """``admm2`` (dense Schur factor, the rhs all-gathered) and ``admm``
    (one psum per Jacobi sweep) on the mesh: x within 1e-9 of JAX's mesh
    solve on 8 devices and of the port's one-device solve."""
    got = _port(port_runs, world_size, name)
    for x, _ in (_jax_solve(name), _one_device(name)):
        np.testing.assert_allclose(got["x"], x, atol=1e-9)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_admm2_mesh_cg_regime_matches_dense_regime(port_runs, world_size):
    """``dense_threshold=0`` forces the sharded CG Schur solve: x within
    1e-7 of the dense regime's, and of JAX's CG regime."""
    cg = _port(port_runs, world_size, "admm2_cg")
    dense = _port(port_runs, world_size, "admm2_dense")
    np.testing.assert_allclose(cg["x"], dense["x"], atol=1e-7)
    np.testing.assert_allclose(cg["x"], _jax_solve("admm2_cg")[0], atol=1e-7)


def test_admm_mesh_device_count_invariance(port_runs):
    """One, two and four ranks: x within 1e-9; one Jacobi psum per sweep
    and one for Aᵀλ, nb_inner + 1 = 3 n-vector psums an iteration."""
    xs = [_port(port_runs, ws, "admm_200") for ws in WORLD_SIZES]
    for got in xs[1:]:
        np.testing.assert_allclose(got["x"], xs[0]["x"], atol=1e-9)
    for got in xs:
        n = len(got["x"])
        vec = {numel: v for (op, numel), v in got["calls"].items()
               if op == "sum" and numel > 1}
        assert len(vec) == 1 and list(vec.values()) == [3 * 200]
        assert list(vec)[0] > n  # the standard form's slack columns


def test_admm2_solves_to_optimum_on_mesh(port_runs):
    """Four ranks, 3,000 iterations with ``adaptive_rho``: the cost within
    1e-2 of HiGHS's and the violation below 5e-3 (the JAX test's bar)."""
    got = _port(port_runs, 4, "admm2_opt")
    lp = workers.make_lp(RANDOM_ADMM)
    ref, _ = lp.solve(method="scipy_simplex")
    assert abs(lp.cost(got["x"]) - lp.cost(ref)) < 1e-2
    assert lp.max_constraint_violation(got["x"]) < 5e-3


def test_mesh_dispatch_accepts_full_cp_option_surface(port_runs):
    """Every CP option reaches the mesh path: the solve returns finite x."""
    assert np.all(np.isfinite(_port(port_runs, 4, "cp_options")["x"]))


@pytest.mark.parametrize("world_size", [2, 4])
def test_admm_dia_shards_match_csr_shards(port_runs, world_size):
    """The ADMM chunk with each rank's rows as DIA planes (H-DIA's twin
    with shard offsets) and as CSR: x within 1e-12, 50 iterations."""
    got = _port(port_runs, world_size, "admm_layouts")
    assert (got["dia"]["operator"], got["tiles"]["operator"]) == ("dia",
                                                                 "tiles")
    np.testing.assert_allclose(got["dia"]["x"], got["tiles"]["x"], atol=1e-12)
    assert abs(got["dia"]["energy"] - got["tiles"]["energy"]) < 1e-10


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_admm_blocks_mesh_matches_jax_and_one_device(port_runs, world_size):
    """The block batch sharded (4 blocks padded to a multiple of the rank
    count): x within 1e-10 of JAX's mesh solve (8 devices) and of the
    one-device port; on one rank equal to it bit for bit."""
    got = _port(port_runs, world_size, "admm_blocks")
    one, _ = _one_device("admm_blocks")
    np.testing.assert_allclose(got["x"], _jax_solve("admm_blocks")[0],
                               atol=1e-10)
    np.testing.assert_allclose(got["x"], one, atol=1e-10)
    if world_size == 1:
        np.testing.assert_array_equal(got["x"], one)
    # one psum of the consensus sums an iteration (the standard form's
    # n + 1 entries), a psum and a pmax of one scalar a checkpoint
    assert sorted(got["calls"].values()) == [2, 2, 200]


# ----------------------------------------------------------------------
# dual gradient ascent and blocked coordinate ascent (test_sharding.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sharded_dual_gradient_ascent_matches_single_chip(port_runs,
                                                          world_size):
    """One iteration: the dual objective within rtol 1e-12 of JAX's mesh
    solve and of the one-device port, and at most four n-vector psums (two
    reduced costs, two directions with gᵀb packed beside).  2,000
    iterations: the JAX test's bar (both dual bounds below the optimum,
    within 0.15 of each other relative to the gap): the exact line
    search's breakpoint sort turns a last-ulp difference of the psum's
    order into another, equally valid, ascent path."""
    got = _port(port_runs, world_size, "dga_1")
    for _x, dobj in (_jax_solve("dga_1"), _one_device("dga_1")):
        np.testing.assert_allclose(got["dobj"], dobj, rtol=1e-12)
    n = len(got["x"])
    assert got["calls"][("sum", n + 1)] == 2
    assert got["calls"][("sum", n)] == 2 + 1
    lp = workers.make_lp(RANDOM_DUAL)
    ref, _ = lp.solve(method="scipy_simplex")
    opt = float(lp.costsvector @ ref)
    e_mesh = _port(port_runs, world_size, "dga_2000")["dobj"][-1]
    for _x, dobj in (_jax_solve("dga_2000"), _one_device("dga_2000")):
        e1 = dobj[-1]
        assert e1 <= opt + 1e-9 and e_mesh <= opt + 1e-9
        assert abs(e_mesh - e1) < 0.15 * (1 + abs(opt) - min(e1, e_mesh))


@pytest.mark.parametrize("world_size", [2, 4])
def test_dga_dia_shards_match_csr_shards(port_runs, world_size):
    """DGA with the rows as DIA planes (H-DIA's twin with shard offsets)
    and as CSR, one iteration: y within 1e-12 (x is not compared: the
    step ends on breakpoints, where a reduced cost is zero up to the
    products' rounding and x takes either bound)."""
    got = _port(port_runs, world_size, "dga_dia")
    assert got["dia"]["info"]["operator"] == "dia"
    assert got["tiles"]["info"]["operator"] == "tiles"
    for k in ("y_eq", "y_ineq"):
        np.testing.assert_allclose(got["dia"][k], got["tiles"][k],
                                   atol=1e-12)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sharded_dca_matches_single_chip_blocked(port_runs, world_size):
    """Eight blocked sweeps with the colour groups split over the ranks:
    x and the dual curve equal the one-device blocked sweep bit for bit
    (the same ties, the merge exact), x within 1e-8 of JAX's mesh solve;
    two psums a colour group and sweep."""
    got = _port(port_runs, world_size, "dca_8")
    spec, kw = SOLVES["dca_8"]
    lp = workers.make_lp(spec)
    one, _ = lp.solve(device="cpu", mode="blocked", **kw)
    np.testing.assert_array_equal(got["x"], one)
    assert got["dobj"] == list(lp.dobj_curve)
    np.testing.assert_allclose(got["x"], _jax_solve("dca_8")[0], atol=1e-8)
    colours = {k: len(_color_rows(getattr(lp, k).tocsr()))
               for k in ("a_equalities", "a_inequalities")}
    sweeps = len(got["dobj"])
    m_eq, m_in = lp.a_equalities.shape[0], lp.a_inequalities.shape[0]
    assert got["calls"][("sum", m_eq)] == colours["a_equalities"] * sweeps
    assert got["calls"][("sum", m_in)] == colours["a_inequalities"] * sweeps
    n = lp.nb_variables
    assert got["calls"].get(("sum", n), 0) + got["calls"].get(
        ("sum", n + 1), 0) == sweeps * sum(colours.values())


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("case", sorted(DCA_MERGE))
def test_sharded_dca_merge_keeps_signed_zeros(port_runs, world_size, case):
    """One colour sweep split over the ranks from a state with -0 in c̄ at
    column 0 (padding, on several ranks) and at a stored zero's column:
    y, c̄ and the key equal the one-device sweep bit for bit, which turns
    both to +0 as JAX's compiled ``_dca_color_sweep`` does (float64).  A
    group whose column 0 several ranks touch sends one more word."""
    from test_torch_dca_sweep import _bits, _jax_sweep

    from pysparselp_tpu_torch.ops import dca_sweep as pdca
    from pysparselp_tpu_torch.utils.jax_prng import prng_key

    owner, dtype, project = DCA_MERGE[case]
    host = _zero_merge_system(owner)
    got = _port(port_runs, world_size, case)
    dt = getattr(torch, dtype)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dt)

    ell = pdca.EllRows.from_scipy(host["a"], dt, "cpu")
    groups = _color_rows(host["a"])
    plan = pdca.ColorPlan.build(ell, groups, t(host["b"]), t(host["lb"]),
                                t(host["ub"]))
    y, c_bar, key = pdca.dca_color_sweep_reference(
        ell, plan, t(host["b"]), torch.as_tensor(host["active"]),
        t(host["y"]), t(host["c_bar"]), t(host["lb"]), t(host["ub"]),
        prng_key(4), project)
    assert torch.equal(_bits(torch.as_tensor(got["y"])), _bits(y))
    assert torch.equal(_bits(torch.as_tensor(got["c_bar"])), _bits(c_bar))
    assert tuple(got["key"]) == tuple(key)
    for col in (0, 2):
        assert c_bar[col] == 0 and not torch.signbit(c_bar[col])
    if dtype == "float64":
        wy, wc, _ = _jax_sweep(host, np.float64, prng_key(4), project,
                               groups)
        assert torch.equal(_bits(torch.as_tensor(wc)), _bits(c_bar))
        assert torch.equal(_bits(torch.as_tensor(wy)), _bits(y))
    n = host["a"].shape[1]
    shared = sum(got["shared"])
    assert got["calls"].get(("sum", n), 0) == len(groups) - shared
    assert got["calls"].get(("sum", n + 1), 0) == shared
    assert (shared > 0) == (world_size > 1)


def test_sharded_dca_device_count_invariance(port_runs):
    """One, two and four ranks: the same x and dual curve, bit for bit."""
    one = _port(port_runs, 1, "dca_8")
    for ws in WORLD_SIZES[1:]:
        got = _port(port_runs, ws, "dca_8")
        np.testing.assert_array_equal(got["x"], one["x"])
        assert got["dobj"] == one["dobj"]


# ----------------------------------------------------------------------
# JAX sharded states carried across (utils.convert.sharded_from_jax)
# ----------------------------------------------------------------------

def _port_ipm_host(data):
    """The port's IPM shard as numpy: c, col_mask, b and the dense block."""
    a = data["a"] if "a" in data else torch.as_tensor(
        _csr_dense(data["csr"]))
    return [np.asarray(data[k]) for k in ("c", "col_mask", "b")] + [
        np.asarray(a)]


def _csr_dense(op):
    m, n = op.shape
    return scipy.sparse.csr_matrix(
        (op.vals.numpy(), op.indices.numpy(), op.indptr.numpy()),
        shape=(m, n)).toarray()


@pytest.mark.parametrize("threshold", [4096, 0], ids=["dense", "cg"])
def test_ipm_shards_from_jax(threshold):
    """JAX's column blocks on 8 devices carried to 2 port ranks equal the
    port's own blocks; JAX's initial point carried to one port rank takes
    the interior point's next iterate as JAX's does (x, y, s within
    1e-10, float64)."""
    import jax

    from pysparselp_tpu.parallel import sharded_mehrotra as jsm
    from pysparselp_tpu_torch.parallel import sharded_mehrotra as psm
    from pysparselp_tpu_torch.utils.convert import sharded_from_jax
    from torch_port_helpers import one_rank_mesh

    a, b, c = _standard_form(6, 25, 11)
    n = c.size
    mesh = _jax_mesh(8)
    jdata, _n_loc, dense = jsm.build_sharded_ipm_data(
        a, b, c, mesh, np.float64, threshold)
    host = jax.tree.map(np.asarray, jdata)
    for rank in range(2):
        got = sharded_from_jax(host, None, 2, rank, dtype=np.float64,
                               layout="ipm", n=n, dense_threshold=threshold)
        want = psm.build_ipm_shard(a, b, c, 2, rank, torch.float64, "cpu",
                                   threshold)
        assert got[1:] == want[1:]
        for g, w in zip(_port_ipm_host(got[0]), _port_ipm_host(want[0])):
            np.testing.assert_array_equal(g, w)
    x, y, s = jsm._initial_point_sharded(jdata, mesh, dense, n)
    theta = jax.numpy.asarray(0.9995)
    want = jsm._ipm_iteration_sharded(jdata, x, y, s, theta,
                                      jax.numpy.asarray(1.0), mesh, dense, n)
    data, _n_loc, use_dense, state = sharded_from_jax(
        host, [np.asarray(v) for v in (x, y, s)], 1, 0,
        dtype=np.float64, layout="ipm", n=n, dense_threshold=threshold)
    assert use_dense == dense
    with one_rank_mesh() as pmesh:
        got = psm._ipm_iteration_sharded(
            data, *state, torch.tensor(0.9995, dtype=torch.float64), 1.0,
            use_dense, n, pmesh)
    # one port rank holds every column; JAX's padding columns come last
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).reshape(-1)[:g.numel()], atol=1e-10)


def test_admm_rows_from_jax():
    """JAX's row system of ``admm`` (block-ELL tiles, 8 devices) carried to
    2 and 3 port ranks: each rank's rows equal the port's own shard, and
    the row-sharded dual is split again."""
    import jax

    from pysparselp_tpu.parallel import sharded_admm as jsa
    from pysparselp_tpu_torch.parallel import sharded_admm as psa
    from pysparselp_tpu_torch.solvers.admm import admm_system
    from pysparselp_tpu_torch.utils.convert import sharded_from_jax

    lp = workers.make_lp(RANDOM_ADMM)
    _c, a, b, *_ = admm_system(
        lp.costsvector, lp.a_equalities.tocsr(), lp.b_equalities,
        lp.a_inequalities.tocsr(), lp.b_lower, lp.b_upper, lp.lower_bounds,
        lp.upper_bounds)
    m, n = a.shape
    jdata, rows_j, _m_pad, _a = jsa.build_sharded_system(
        a, b, _jax_mesh(8), np.float64)
    host = jax.tree.map(np.asarray, jdata)
    lam = np.zeros(8 * rows_j)
    lam[:m] = np.arange(m) + 1.0
    for ndev in (2, 3):
        for rank in range(ndev):
            sys_l, rows_loc, lam_l = sharded_from_jax(
                host, lam.reshape(8, rows_j), ndev, rank,
                dtype=np.float64, layout="admm", m=m, n=n)
            want, want_rows, _mp, _op = psa.build_sharded_system(
                a, b, _FakeMesh(ndev, rank), torch.float64,
                operator="tiles")
            assert rows_loc == want_rows
            np.testing.assert_array_equal(_csr_dense(sys_l["csr"]),
                                          _csr_dense(want["csr"]))
            for k in ("b", "row_mask"):
                np.testing.assert_array_equal(sys_l[k], want[k])
            part = (np.arange(m) + 1.0)[rank * rows_loc:][:rows_loc]
            np.testing.assert_array_equal(lam_l[:part.size], part)


class _FakeMesh:
    """The rank count, rank and device of a mesh, for the host builders
    that read nothing else."""

    def __init__(self, size, rank):
        from pysparselp_tpu_torch.parallel.mesh import Mesh

        self.__class__ = type("FakeMesh", (Mesh,), {})
        self.size, self.rank, self.device = size, rank, torch.device("cpu")


def test_dca_groups_from_jax():
    """JAX's colour groups padded for 8 devices carried across are the
    port's colour groups."""
    from pysparselp_tpu.parallel.sharded_dca import pad_groups
    from pysparselp_tpu_torch.utils.convert import sharded_from_jax

    a = workers.make_lp(RANDOM_DUAL).a_inequalities.tocsr()
    groups = _color_rows(a)
    got = sharded_from_jax(pad_groups(groups, 8, a.shape[0]), None, 2, 0,
                           layout="dca", m=a.shape[0])
    assert len(got) == len(groups)
    for g, w in zip(got, groups):
        np.testing.assert_array_equal(g, w)


def test_blocks_from_jax():
    """JAX's block batch padded for 8 devices, carried to 3 port ranks,
    equals the port's own padding and slicing; so does the state."""
    from pysparselp_tpu.solvers import admm_blocks as jab
    from pysparselp_tpu_torch.solvers import admm_blocks as pab
    from pysparselp_tpu_torch.utils.convert import sharded_from_jax

    lp = workers.make_lp(BLOCKY)
    a = lp.a_inequalities.tocsr()
    a.blocks = list(lp.a_inequalities.blocks)
    blocks = jab._build_blocks(a, lp.b_upper)
    padded = jab._pad_blocks_to(blocks, 8)
    rng = np.random.RandomState(0)
    state = [rng.rand(*padded["col_mask"].shape) * padded["col_mask"]
             for _ in range(2)] + [rng.rand(a.shape[1] + 1)]
    mine = pab._pad_blocks_to(pab._build_blocks(a, lp.b_upper), 6)
    for rank in range(3):
        got, (x_b, lam_b, xp) = sharded_from_jax(
            padded, state, 3, rank, dtype=np.float64, layout="blocks",
            nb_blocks=blocks["nb_blocks"])
        sl = slice(2 * rank, 2 * rank + 2)
        for k in ("sub_a", "ids", "row_mask", "col_mask", "beq_pad"):
            np.testing.assert_array_equal(got[k], mine[k][sl])
        want_xb = np.concatenate([state[0][:4], np.zeros((2,) + state[0]
                                                         .shape[1:])])
        np.testing.assert_array_equal(x_b.numpy(), want_xb[sl])
        np.testing.assert_array_equal(xp.numpy(), state[2])


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_mesh_solvers_on_cuda():
    """Two gloo ranks sharing the card (H-CSR, H-DCA's colour step and the
    dense products on their shards, float64) against the same two ranks
    on the CPU (the twins): x within 1e-8 for the interior point and the
    ADMM solvers, the blocked DCA's dual curve within 1e-9 relative."""
    from torch_port_helpers import cuda_or_skip

    cuda_or_skip()
    cases = [(name, "lp_solve", SOLVES[name]) for name in (
        "mehrotra_dispatch", "admm", "admm2_cg", "dca_8", "admm_blocks")]
    gpu = spawn(workers.run_cases, 2, "gloo", "cuda", cases)
    cpu = spawn(workers.run_cases, 2, "gloo", "cpu", cases)
    for name in ("mehrotra_dispatch", "admm", "admm2_cg", "admm_blocks"):
        np.testing.assert_allclose(gpu[name]["x"], cpu[name]["x"], atol=1e-8,
                                   err_msg=name)
    np.testing.assert_allclose(gpu["dca_8"]["dobj"], cpu["dca_8"]["dobj"],
                               rtol=1e-9)
