"""The position-sharded CP port (``pysparselp_tpu_torch.parallel.
sharded_cp_windowed``, H-CPDIA's shard entry per rank with a halo exchange)
against the JAX package's (``pysparselp_tpu/parallel/sharded_cp_windowed.py``),
on the CPU in float32.

JAX's side runs here as ``tests/test_sharded_windowed.py`` runs it: its
20,000-position systems (offsets (-3, 0, 5, 130), with and without the
equality offsets (-1, 0, 2)) on 4 of the conftest's virtual CPU devices,
the windowed kernel in interpret mode under small window budgets.  The
port's ranks are gloo processes (``parallel.mesh.spawn``, world sizes 1, 2
and 4, spawned once per module in the background), which start from JAX's
state through ``utils.convert.sharded_from_jax(layout="position")`` with
the plan's CPU gate open (``_FORCE_CPU``, off by default).  Each test
states its tolerance.

JAX is imported inside the tests: the card machine, which runs this file's
``cuda`` case (``python -m pytest --noconftest -m cuda``), has none.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import scipy.sparse
import torch

import torch_sharded_workers as workers
from pysparselp_tpu_torch.ops.cp_dia import (SHARD_LAUNCHES, TWO_LAUNCH,
                                             cp_dia_chunk,
                                             cp_dia_chunk_reference,
                                             cp_dia_shard_step,
                                             cp_dia_shard_step_reference)
from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw
from pysparselp_tpu_torch.parallel.mesh import halo_pack, halo_unpack, spawn
from pysparselp_tpu_torch.problem import DiaMatrix, LPProblem
from torch_port_helpers import (assert_same_bits, cuda_or_skip,
                                nan_signed_zero_case)

torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4)
JAX_DEVICES = 4
OFFSETS = (-3, 0, 5, 130)
EQ_OFFSETS = (-1, 0, 2)
NSTEPS = 5
# the restart controller: iterations and check period (JAX's test's)
RESTART = (45, 20)
# the end-to-end solves (JAX's test's LP and run)
SOLVE = dict(nb_iter=400, nb_iter_plot=200, dtype=np.float32, permute=False)
SOLVE_RESTART = dict(nb_iter=120, nb_iter_plot=60, restart="average",
                     restart_period=30, omega=1.3, dtype=np.float32,
                     permute=False)


def _dia(n, offsets, rng):
    mats = [rng.rand(n) * 2 - 1 for _ in offsets]
    return scipy.sparse.diags(mats, offsets, shape=(n, n)).tocsr()


def _system(n=20000, eq=False, seed=0):
    """``tests/test_sharded_windowed.py``'s aligned system."""
    rng = np.random.RandomState(seed)
    a = _dia(n, OFFSETS, rng)
    a_eq = _dia(n, EQ_OFFSETS, rng) if eq else None
    return dict(
        a_eq=a_eq, beq=rng.rand(n) if eq else None,
        a_ineq=a, b_ineq=rng.rand(n) * 2,
        c=rng.rand(n), lb=np.zeros(n), ub=np.ones(n) * 2,
        x0=rng.rand(n), x30=None,
        y_eq0=rng.rand(n) * 0.1 if eq else None,
        y_ineq0=rng.rand(n) * 0.1,
    )


def _solve_lp(seed=3, n=20000):
    """The end-to-end LP of JAX's test: costs, A and b of ``min cx, A x <=
    b, 0 <= x <= 2``."""
    rng = np.random.RandomState(seed)
    a = _dia(n, OFFSETS, rng)
    return rng.rand(n) - 0.3, a, rng.rand(n) * 2 + 0.5


def _numpy_tree(data):
    """The JAX data dict's arrays and scalars as numpy (the keys
    ``sharded_from_jax(layout="position")`` reads), so they pickle into the
    port's ranks."""
    keep = ("plan", "n", "m", "m_eq", "has_eq", "theta", "offsets",
            "offsets_t", "eq_offsets", "eq_offsets_t")
    out = {k: data[k] for k in keep}
    out["consts"] = tuple(np.asarray(a, np.float64) for a in data["consts"])
    out["planes"] = tuple(np.asarray(a, np.float64) for a in data["planes"])
    return out


def _numpy_state(state):
    return {k: np.asarray(v, np.float64) for k, v in state.items()}


@functools.lru_cache(maxsize=None)
def _jax_refs():
    """JAX's position-sharded runs on its 4-device mesh, per system (eq
    False/True): the built data and state, 5 iterations of
    ``sharded_windowed_chunk``, the metrics of that state, the restart
    controller from the built state, and the end-to-end solve."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pysparselp_tpu import SparseLP
    from pysparselp_tpu.ops import cp_windowed as cw
    from pysparselp_tpu.parallel import sharded_cp_windowed as jscw
    from pysparselp_tpu.problem import DiaMatrix as JDia
    from pysparselp_tpu.problem import LPProblem as JProb
    from pysparselp_tpu.solvers.chambolle_pock import _kkt_score

    mesh = Mesh(np.array(jax.devices()[:JAX_DEVICES]), ("pos",))
    f32 = jnp.float32
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        # budgets of tests/test_sharded_windowed.py: >= 4 interior windows
        mp.setattr(cw, "_MIN_WQ", 32)
        mp.setattr(cw, "_FORCE_INTERPRET", True)
        for eq in (False, True):
            mp.setattr(cw, "WINDOWED_VMEM_BUDGET",
                       2_000_000 if eq else 1_500_000)
            sys_d = _system(eq=eq)
            n = sys_d["c"].size
            info = jscw.position_shard_plan(sys_d["a_eq"], sys_d["a_ineq"],
                                            n, n if eq else 0, n,
                                            JAX_DEVICES, np.float32)
            data, state0 = jscw.build_position_sharded(sys_d, mesh,
                                                       plan_info=info)
            state = jscw.sharded_windowed_chunk(data, state0, mesh, NSTEPS)
            metrics = jscw.sharded_windowed_metrics(data, state, mesh)
            prob = JProb(
                c=jnp.asarray(sys_d["c"], f32),
                lb=jnp.asarray(sys_d["lb"], f32),
                ub=jnp.asarray(sys_d["ub"], f32),
                a_eq=JDia.from_scipy(sys_d["a_eq"], dtype=f32) if eq
                else None,
                b_eq=jnp.asarray(sys_d["beq"], f32) if eq else None,
                a_ineq=JDia.from_scipy(sys_d["a_ineq"], dtype=f32),
                b_lower=None, b_upper=jnp.asarray(sys_d["b_ineq"], f32),
                n=n, m_eq=n if eq else 0, m_ineq=n)
            ye0 = (jnp.asarray(sys_d["y_eq0"], f32) if eq
                   else jnp.zeros(0, f32))
            mu0 = _kkt_score(prob, jnp.asarray(sys_d["x0"], f32), ye0,
                             jnp.asarray(sys_d["y_ineq0"], f32)).astype(f32)
            rs = {"state": state0, "omega": jnp.asarray(1.0, f32),
                  "mu_restart": mu0, "mu_last": jnp.asarray(np.inf, f32),
                  "zx": state0["x"], "zeq": state0.get("y_eq"),
                  "zineq": state0["y_ineq"]}
            rs = jscw.sharded_windowed_chunk_restart(data, rs, mesh,
                                                     *RESTART)
            refs[eq] = dict(
                data=_numpy_tree(data), state0=_numpy_state(state0),
                state=_numpy_state(state), mu0=float(mu0),
                chunk=dict(zip(("x", "x3", "y_eq", "y"),
                               jscw.unshard_state(data, state))),
                metrics={k: float(v) for k, v in metrics.items()},
                restart=dict(zip(("x", "x3", "y_eq", "y"),
                                 jscw.unshard_state(data, rs["state"])),
                             omega=float(rs["omega"]),
                             mu_restart=float(rs["mu_restart"]),
                             mu_last=float(rs["mu_last"])))
        mp.setattr(cw, "WINDOWED_VMEM_BUDGET", 1_500_000)
        c, a, b = _solve_lp()
        lp = SparseLP()
        lp.add_variables_array(c.size, lower_bounds=0, upper_bounds=2,
                               costs=c)
        lp.add_inequality_constraints_sparse(a, None, b)
        x, _ = lp.solve(method="chambolle_pock_ppd", mesh=mesh, **SOLVE)
        refs["solve"] = dict(
            x=np.asarray(x), itrn=list(lp.itrn_curve),
            curves={k: [float(v) for v in getattr(lp, k)]
                    for k in ("pobj_curve", "dobj_curve",
                              "max_violated_inequality")},
            regime=jscw.last_run_info["regime"])
    return refs


def _port_cases(refs):
    cases = []
    for eq in (False, True):
        r = refs[eq]
        cases += [
            (f"chunk{int(eq)}", "pos_chunk", (r["data"], r["state0"],
                                              NSTEPS)),
            (f"restart{int(eq)}", "pos_restart",
             (r["data"], r["state0"], r["mu0"], *RESTART)),
            (f"metrics{int(eq)}", "pos_metrics", (r["data"], r["state"]))]
    c, a, b = _solve_lp()
    cases += [("solve", "pos_solve", (c, a, b, SOLVE)),
              ("solve_light", "pos_solve", (c, a, b,
                                            dict(SOLVE, light_metrics=True))),
              ("solve_restart", "pos_solve", (c, a, b, SOLVE_RESTART)),
              ("solve_f64", "pos_solve", (c, a, b,
                                          dict(SOLVE, nb_iter=2,
                                               nb_iter_plot=1,
                                               dtype=np.float64)))]
    return cases


@pytest.fixture(scope="module")
def runs():
    """``{world_size: {case: result}}`` of the port's ranks and JAX's
    references; the spawns start once JAX's data exist and run beside the
    rest of the JAX module's tests."""
    refs = _jax_refs()
    cases = _port_cases(refs)
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLD_SIZES))
    futures = {n: pool.submit(spawn, workers.run_cases, n, "gloo", "cpu",
                              cases) for n in WORLD_SIZES}
    yield refs, {n: f.result() for n, f in futures.items()}
    pool.shutdown(wait=True)


def _close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
def test_chunk_matches_jax(runs, world_size, eq):
    """5 iterations from JAX's built state against JAX's
    ``sharded_windowed_chunk``, at JAX's own test's limits (x 3e-5, x3
    6e-5, y and y_eq 3e-5 absolute); one halo exchange an iteration, none
    on one rank."""
    refs, port = runs
    got, want = port[world_size][f"chunk{int(eq)}"], refs[eq]["chunk"]
    _close(got["x"], want["x"], 3e-5, "x")
    _close(got["x3"], want["x3"], 6e-5, "x3")
    _close(got["y"], want["y"], 3e-5, "y")
    if eq:
        _close(got["y_eq"], want["y_eq"], 3e-5, "y_eq")
    halos = {k: v for k, v in got["calls"].items() if k[0] == "halo"}
    assert sum(halos.values()) == (NSTEPS if world_size > 1 else 0)
    assert set(got["calls"]) == set(halos)


@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
def test_iterates_identical_on_every_rank_count(runs, eq):
    """The iterates do not depend on the rank count, bit for bit."""
    _refs, port = runs
    one = port[1][f"chunk{int(eq)}"]
    for world_size in WORLD_SIZES[1:]:
        got = port[world_size][f"chunk{int(eq)}"]
        for key in ("x", "x3", "y", "y_eq"):
            assert np.array_equal(got[key], one[key]), (world_size, key)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
def test_restart_controller_matches_jax(runs, world_size, eq):
    """``sharded_windowed_chunk_restart`` (45 iterations, a check every
    20) against JAX's: ω, the scores and the seeding score within rtol
    1e-4, the iterates within rtol 1e-4, atol 1e-5."""
    refs, port = runs
    got, want = port[world_size][f"restart{int(eq)}"], refs[eq]["restart"]
    for key in ("omega", "mu_restart", "mu_last"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["kkt0"], refs[eq]["mu0"], rtol=1e-4)
    for key in ("x", "x3", "y") + (("y_eq",) if eq else ()):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
def test_metrics_match_jax(runs, world_size, eq):
    """``sharded_windowed_metrics`` of JAX's 5-iteration state against
    JAX's, within rtol 1e-4, atol 1e-5 (the scalars sum in another
    order); the rounded iterate's feasibility equal."""
    refs, port = runs
    got, want = port[world_size][f"metrics{int(eq)}"], refs[eq]["metrics"]
    for key in ("energy1", "energy2", "energy_rounded",
                "max_violated_equality", "max_violated_inequality"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert got["rounded_feasible"] == want["rounded_feasible"]


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_end_to_end_solve_matches_jax(runs, world_size):
    """``SparseLP.solve(mesh=...)`` routes the float32 DIA system to the
    position-sharded regime, as JAX's does, and its x and checkpoint
    curves agree with JAX's mesh solve (x 1e-4 absolute, JAX's mesh-vs-one
    -chip limit; curves rtol 1e-4, atol 1e-5); ``light_metrics`` gives the
    same curves."""
    refs, port = runs
    want = refs["solve"]
    assert want["regime"] == "position-sharded-windowed"
    for case in ("solve", "solve_light"):
        got = port[world_size][case]
        info = got["info"]
        assert info["regime"] == "position-sharded", info
        assert info["ranks"] == world_size
        assert info["positions_per_rank"] == -(-20000 // world_size)
        assert info["x_halo"] == (3, 130) and info["y_halo"] == (133, 133)
        assert got["itrn"] == want["itrn"] == [200, 400]
        _close(got["x"], want["x"], 1e-4, case)
        for key, curve in want["curves"].items():
            np.testing.assert_allclose(got["curves"][key], curve, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{case} {key}")


def test_restart_and_float64_routes(runs):
    """``restart="average"`` stays position-sharded and agrees with the
    port's one-device accelerated solve (atol 1e-3, JAX's test's limit);
    float64 takes the row-sharded DIA path."""
    from pysparselp_tpu_torch.modeling import SparseLP

    _refs, port = runs
    c, a, b = _solve_lp()
    lp = SparseLP()
    lp.add_variables_array(c.size, lower_bounds=0, upper_bounds=2, costs=c)
    lp.add_inequality_constraints_sparse(a, None, b)
    x_one, _ = lp.solve(method="chambolle_pock_ppd", device="cpu",
                        **SOLVE_RESTART)
    for world_size in WORLD_SIZES:
        got = port[world_size]["solve_restart"]
        assert got["info"]["regime"] == "position-sharded"
        assert got["info"]["restart"] == "average"
        _close(got["x"], x_one, 1e-3, f"restart {world_size}")
        f64 = port[world_size]["solve_f64"]["info"]
        assert f64["regime"] == "row-sharded-csr", f64


def test_plan_gates_match_jax(monkeypatch):
    """``position_shard_plan`` refuses what JAX's refuses: float64, a
    system that does not lower to DIA, no inequality system, shards
    narrower than their halo, and the CPU without the test hook; and takes
    the 20,000-position system on 4 ranks."""
    from pysparselp_tpu.ops import cp_windowed as cw
    from pysparselp_tpu.parallel import sharded_cp_windowed as jscw

    monkeypatch.setattr(cw, "_MIN_WQ", 32)
    monkeypatch.setattr(cw, "WINDOWED_VMEM_BUDGET", 1_500_000)
    rng = np.random.RandomState(0)
    band = _dia(20000, OFFSETS, rng)
    scattered = scipy.sparse.random(4000, 4000, density=0.01,
                                    random_state=rng, format="csr")
    small = _dia(1000, OFFSETS, rng)
    cases = {
        "band": ((None, band, 20000, 0, 20000, 4, np.float32), True),
        "float64": ((None, band, 20000, 0, 20000, 4, np.float64), False),
        "scattered": ((None, scattered, 4000, 0, 4000, 4, np.float32),
                      False),
        "no_ineq": ((band, None, 20000, 20000, 0, 4, np.float32), False),
        "narrow": ((None, small, 1000, 0, 1000, 8, np.float32), False),
    }
    for name, (args, eligible) in cases.items():
        for force in (True, False):
            monkeypatch.setattr(cw, "_FORCE_INTERPRET", force)
            monkeypatch.setattr(scw, "_FORCE_CPU", force)
            want = jscw.position_shard_plan(*args)
            got = scw.position_shard_plan(*args, device="cpu")
            assert (want is not None) == (got is not None) == (
                eligible and force), name
    monkeypatch.setattr(scw, "_FORCE_CPU", False)
    info = scw.position_shard_plan(None, band, 20000, 0, 20000, 4,
                                   torch.float32, device="cuda")
    assert info["plan"] == dict(positions=20000, width=5000,
                                x_halo=(3, 130), y_halo=(133, 133))


def _global_problem(glob, dtype, device):
    """The whole system of ``glob`` as the one-device LPProblem and steps."""
    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    def dia(s, rows):
        return DiaMatrix.from_planes(s["vals"], s["offsets"], s["vals_t"],
                                     s["offsets_t"], rows, glob["n"], dtype,
                                     device)

    eq = glob["dia_eq"] is not None
    prob = LPProblem(
        c=vec(glob["c"]), lb=vec(glob["lb"]), ub=vec(glob["ub"]),
        a_eq=dia(glob["dia_eq"], glob["m_eq"]) if eq else None,
        b_eq=vec(glob["beq"]) if eq else None,
        a_ineq=dia(glob["dia"], glob["m"]), b_lower=None,
        b_upper=vec(glob["b_ineq"]), n=glob["n"], m_eq=glob["m_eq"],
        m_ineq=glob["m"])
    pre = dict(diag_t=vec(glob["diag_t"]), sigma_ineq=vec(glob["sigma_ineq"]))
    if eq:
        pre["sigma_eq"] = vec(glob["sigma_eq"])
    state = (vec(glob["x"]), vec(glob["y_eq"]) if eq else vec(np.zeros(0)),
             vec(glob["y_ineq"]))
    return prob, pre, state


def _glob(eq, nan_case, ndev):
    """``position_system`` of the 20,000-position system (``nan_case``:
    with a NaN cost and bound and runs of signed zeros)."""
    sys_d = _system(eq=eq, seed=2)
    if nan_case:
        sys_d, (x, ye, yi) = nan_signed_zero_case(sys_d, seed=3)
        sys_d.update(x0=x, y_eq0=ye if eq else None, y_ineq0=yi)
    n = sys_d["c"].size
    info = scw.position_shard_plan(sys_d["a_eq"], sys_d["a_ineq"], n,
                                   n if eq else 0, n, ndev, np.float32,
                                   device="cuda")
    return scw.position_system(sys_d, info)


def _run_shards(glob, ndev, dtype, device, nsteps, step):
    """``nsteps`` iterations of ``step(data, state)`` on every rank of
    ``ndev`` in this process, the halos copied by hand between them;
    returns the gathered ``(x, x3, y_eq, y)``."""
    ranks = [scw.place_position_shard(glob, ndev, r, dtype, device)
             for r in range(ndev)]
    for _ in range(nsteps):
        items = [scw.state_halo_items(d, s) for d, s in ranks]
        packets = [halo_pack(i) for i in items]
        for r, it in enumerate(items):
            halo_unpack(it, packets[r - 1] if r else None,
                        packets[r + 1] if r + 1 < ndev else None)
        for d, s in ranks:
            step(d, s)

    def whole(key, size):
        return torch.cat([s[key][slice(*d["shard"].interior)]
                          for d, s in ranks])[:size]

    out = [whole("x", glob["n"]), whole("x3", glob["n"])]
    out.append(whole("y_eq", glob["m_eq"]) if glob["dia_eq"] is not None
               else None)
    return out + [whole("y_ineq", glob["m"])]


def _shard_step(twin):
    fn = cp_dia_shard_step_reference if twin else cp_dia_shard_step

    def step(d, s):
        empty = s["x"].new_zeros(0)
        fn(d["shard"], d["pre"], s["x"], s["x3"], s.get("y_eq", empty),
           s["y_ineq"], d["theta"])
    return step


def _drop_absent(out):
    return [v for v in out if v is not None]


@pytest.mark.parametrize("ndev", [1, 2, 4, 7])
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
@pytest.mark.parametrize("nan_case", [False, True], ids=["plain", "nan"])
def test_shard_twin_equals_chunk_twin_bit_for_bit(ndev, eq, nan_case):
    """On any rank count, 4 iterations of the shard entry's twin, the halos
    copied between the ranks, equal ``cp_dia_chunk_reference`` on the
    whole system bit for bit (NaN and signed zeros included)."""
    glob = _glob(eq, nan_case, ndev)
    dt = torch.float32
    got = _run_shards(glob, ndev, dt, "cpu", 4, _shard_step(True))
    prob, pre, (x, ye, yi) = _global_problem(glob, dt, "cpu")
    out = cp_dia_chunk_reference(prob, pre, x, ye, yi, 4, 1.0)
    want = [out[0], out[1], out[2] if eq else None, out[3]]
    nans, _negzeros = assert_same_bits(_drop_absent(got),
                                       _drop_absent(want), "shard twin")
    assert (nans > 0) == nan_case


def test_shard_rejects_a_halo_short_of_the_taps():
    glob = _glob(False, False, 4)
    data, _state = scw.place_position_shard(glob, 4, 1, torch.float32, "cpu")
    sh = data["shard"]
    with pytest.raises(ValueError, match="reach"):
        type(sh)(g0=sh.g0, length=sh.length - 1, primal=sh.primal,
                 interior=sh.interior, n=sh.n, m=sh.m, me=sh.me, c=sh.c,
                 lb=sh.lb, ub=sh.ub, a_ineq=sh.a_ineq, b_ineq=sh.b_ineq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
@pytest.mark.parametrize("nan_case", [False, True], ids=["plain", "nan"])
def test_shard_kernel_on_cuda(dtype, eq, nan_case):
    """H-CPDIA's shard entry on 4 ranks' slices on the card, the halos
    copied between them: 20 iterations equal the two-launch chunk entry on
    the whole system bit for bit, and the twin on the same inputs within
    rtol 1e-5 (float32) / 1e-12 (float64) of max(1, max |twin|)."""
    dev = cuda_or_skip()
    glob = _glob(eq, nan_case, 4)
    before = cp_dia_shard_step.launches
    got = _run_shards(glob, 4, dtype, dev, 20, _shard_step(False))
    assert cp_dia_shard_step.launches - before == 4 * 20 * SHARD_LAUNCHES
    twin = _run_shards(glob, 4, dtype, dev, 20, _shard_step(True))
    prob, pre, (x, ye, yi) = _global_problem(glob, dtype, dev)
    out = cp_dia_chunk(prob, pre, x, ye, yi, 20, 1.0, plan=TWO_LAUNCH)
    want = [out[0], out[1], out[2] if eq else None, out[3]]
    assert_same_bits(_drop_absent(got), _drop_absent(want), "shard entry")
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for g, w in zip(_drop_absent(got), _drop_absent(twin)):
        finite = torch.isfinite(w)
        scale = max(1.0, float(w[finite].abs().max()))
        assert float((g[finite] - w[finite]).abs().max()) <= rtol * scale
