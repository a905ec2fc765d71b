"""H-CPDIA's shard entry in one cooperative launch a call
(``ops/cp_dia.py::cp_dia_shard_step``, ``csrc/cp_dia_grid.cu``) and the
halo route around it on a mesh (``parallel/mesh.py::HaloRoute``: one
all-gather of the packet the entry writes, one ``index_copy_`` that places
the halos), on the CPU through the twin; and (``cuda``-marked) the kernels against the twin, the two-launch shard
entry and the chunk entry, bit for bit.

The position-sharded solve against JAX's 4-device CPU mesh is held by
``tests/test_torch_sharded_windowed.py`` (it runs this route on 1, 2 and 4
gloo ranks).  The card runs this file's ``cuda`` cases with ``python -m
pytest --noconftest -m cuda``.
"""

import types

import numpy as np
import pytest
import scipy.sparse
import torch

import torch_sharded_workers as workers
from pysparselp_tpu_torch.examples.potts import (
    build_linear_program, build_multilabel_linear_program)
from pysparselp_tpu_torch.ops import cp_dia
from pysparselp_tpu_torch.parallel import sharded_cp_windowed as scw
from pysparselp_tpu_torch.parallel.mesh import (HaloRoute, halo_pack,
                                                halo_unpack, spawn)
from pysparselp_tpu_torch.problem import DiaMatrix, LPProblem
from torch_port_helpers import (assert_same_bits, cuda_or_skip,
                                nan_signed_zero_case, port_problem)

torch.set_num_threads(1)

OFFSETS = (-3, 0, 5, 130)
EQ_OFFSETS = (-1, 0, 2)
N = 6000
NSTEPS = 4


def _dia(n, offsets, rng):
    mats = [rng.rand(n) * 2 - 1 for _ in offsets]
    return scipy.sparse.diags(mats, offsets, shape=(n, n)).tocsr()


def _sys(eq, nan_case, n=N, seed=2):
    """An aligned banded system (the offsets of
    ``tests/test_sharded_windowed.py``) with a seeded start; ``nan_case``:
    a NaN cost and bound and runs of signed zeros."""
    rng = np.random.RandomState(seed)
    sys_d = dict(a_eq=_dia(n, EQ_OFFSETS, rng) if eq else None,
                 beq=rng.rand(n) if eq else None, a_ineq=_dia(n, OFFSETS, rng),
                 b_ineq=rng.rand(n) * 2, c=rng.rand(n), lb=np.zeros(n),
                 ub=np.ones(n) * 2, x0=rng.rand(n), x30=None,
                 y_eq0=rng.rand(n) * 0.1 if eq else None,
                 y_ineq0=rng.rand(n) * 0.1)
    if nan_case:
        sys_d, (x, ye, yi) = nan_signed_zero_case(sys_d, seed=3)
        sys_d.update(x0=x, y_eq0=ye if eq else None, y_ineq0=yi)
    return sys_d


def _glob(sys_d, ndev):
    n = sys_d["c"].size
    m_eq = sys_d["a_eq"].shape[0] if sys_d["a_eq"] is not None else 0
    info = scw.position_shard_plan(sys_d["a_eq"], sys_d["a_ineq"], n, m_eq,
                                   sys_d["a_ineq"].shape[0], ndev,
                                   np.float32, device="cuda")
    return scw.position_system(sys_d, info)


def _whole(glob, dtype, device):
    """The one-device problem, steps and start of ``glob``."""
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
    start = (vec(glob["x"]), vec(glob["y_eq"]) if eq else vec(np.zeros(0)),
             vec(glob["y_ineq"]))
    return prob, pre, start


def _chunk_twin(glob, dtype, nsteps):
    prob, pre, (x, ye, yi) = _whole(glob, dtype, "cpu")
    out = cp_dia.cp_dia_chunk_reference(prob, pre, x, ye, yi, nsteps, 1.0)
    return [out[0], out[1]] + ([out[2]] if glob["dia_eq"] is not None
                               else []) + [out[3]]


def _gathered(glob, ranks, states):
    """The whole ``(x, x3[, y_eq], y)`` from the ranks' interiors."""
    keys = [("x", glob["n"]), ("x3", glob["n"])]
    if glob["dia_eq"] is not None:
        keys.append(("y_eq", glob["m_eq"]))
    keys.append(("y_ineq", glob["m"]))
    return [torch.cat([st[k][slice(*d["shard"].interior)].cpu()
                       for d, st in zip(ranks, states)])[:size]
            for k, size in keys]


# ----------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------

_potts = {}


def _potts_glob(key):
    """Potts-300 / the multi-label 64×64 K = 4 grid as the mesh shards it
    (``chip_smoke.shard_system``'s seeded start)."""
    if key not in _potts:
        import chip_smoke

        lp = (build_linear_program(300, 0.5, 500)[0] if key == "potts300"
              else build_multilabel_linear_program(64, 4)[0])
        sys_, info = chip_smoke.shard_system(lp)
        _potts[key] = (scw.position_system(sys_, info), sys_)
    return _potts[key]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("key, ndev, rank", [
    ("potts300", 1, 0), ("potts300", 4, 1), ("multilabel64", 4, 0),
    ("multilabel64", 4, 3)])
def test_shard_plan_fits_the_shard(key, ndev, rank, dtype):
    """The one-launch entry's grid: one CTA an SM at most and at least
    GRID_MIN_WIDTH positions a CTA over the widened range, slabs that
    cover it with no empty CTA, a warp-rounded block of at most 1,024
    threads, no shared memory; a quarter shard does
    not take 132 × 1,024 threads."""
    glob, _sys = _potts_glob(key)
    data, _state = scw.place_position_shard(glob, ndev, rank, dtype, "cpu")
    sh = data["shard"]
    plan = cp_dia.shard_plan(sh)
    positions = sh.primal[1] - sh.primal[0]
    assert (plan.tier, plan.smem_bytes) == ("shard", 0)
    assert plan.positions == positions
    assert plan.ctas == max(1, min(cp_dia.GRID_SMS,
                                   positions // cp_dia.GRID_MIN_WIDTH))
    assert plan.width * plan.ctas >= positions
    assert plan.width * (plan.ctas - 1) < positions
    assert plan.threads % 32 == 0 and plan.threads <= cp_dia.MAX_THREADS
    assert plan.threads >= min(plan.width, cp_dia.MAX_THREADS)
    assert plan.threads * plan.ctas < positions + 32 * plan.ctas \
        or plan.threads == cp_dia.MAX_THREADS
    if key == "potts300" and ndev == 4:
        assert (plan.ctas, plan.threads) == (132, 704)
    # the packet: x's edges (A's reach), y's (the slice's halos)
    (xl, xr), (yl, yr) = sh.packet_edges
    assert ((xl, xr), (yl, yr)) == (data["plan"]["x_halo"],
                                    data["plan"]["y_halo"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("key", ["potts300", "multilabel64"])
def test_chunk_tier_of_the_sharded_grids(key, dtype):
    """The chunk tier the one-device solve takes on the systems the shard
    entry is held against: H-CPDIA-G with every plane's slab staged, x3
    and y with their halos, then GRID_VECTORS slabs in order while they
    fit the budget; Potts-300 in float64, whose planes do not fit a slab,
    the two-launch kernel."""
    _glob_, sys_ = _potts_glob(key)
    prob, _pre = port_problem(sys_, "dia", dtype)
    plan = cp_dia.grid_plan(prob, dtype)
    if key == "potts300" and dtype == torch.float64:
        assert plan is None
        assert cp_dia.cp_dia_plan(prob, dtype) == cp_dia.TWO_LAUNCH
        return
    assert cp_dia.cp_dia_plan(prob, dtype) == plan
    itemsize = torch.finfo(dtype).bits // 8
    shape = cp_dia._shape(prob, dtype)
    ndiags = tuple(len(o) for o in shape[3])
    m = prob.m_ineq if prob.a_ineq is not None else 0
    me = prob.m_eq if prob.a_eq is not None else 0
    bare = cp_dia.grid_smem_bytes(plan.width, plan.halos, ndiags, m, me,
                                  itemsize, shape[5])
    assert plan.smem_bytes == bare + itemsize * plan.width * len(
        plan.vectors)
    assert plan.smem_bytes <= cp_dia.SMEM_PER_CTA - cp_dia.GRID_STATIC_SMEM
    order = [v for v in cp_dia.GRID_VECTORS if v in plan.vectors]
    assert list(plan.vectors) == order


# ----------------------------------------------------------------------
# the packet and the halo route, through the twin
# ----------------------------------------------------------------------

@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
@pytest.mark.parametrize("nan_case", [False, True], ids=["plain", "nan"])
def test_twin_packet_equals_halo_pack(eq, nan_case):
    """After a step, the twin's outgoing packet is ``halo_pack`` of the
    rank's new state bit for bit, on every rank of 4."""
    glob = _glob(_sys(eq, nan_case), 4)
    for rank in range(4):
        data, st = scw.place_position_shard(glob, 4, rank, torch.float32,
                                            "cpu")
        sh = data["shard"]
        packet = torch.full((sh.packet_size,), np.nan)
        ye = st.get("y_eq", st["x"].new_zeros(0))
        for _ in range(2):
            cp_dia.cp_dia_shard_step_reference(
                sh, data["pre"], st["x"], st["x3"], ye, st["y_ineq"], 1.0,
                packet=packet)
            want = halo_pack(scw.state_halo_items(data, st))
            assert_same_bits([packet], [want], f"packet of rank {rank}")


def _route_ranks(glob, ndev, dtype, device, nsteps, stepper):
    """``nsteps`` iterations on ``ndev`` in-process ranks as the solver
    runs them: on more than one rank each rank's HaloRoute over a stand-in
    mesh (the all-gather done by hand into its ``recv``), its halos placed
    by :meth:`HaloRoute.place`, then the entry, which writes the next
    packet.  Returns the whole state and the placements and entry calls an
    iteration."""
    ranks = [scw.place_position_shard(glob, ndev, r, dtype, device)
             for r in range(ndev)]
    states, routes, steps, calls = [], [], [], [0]
    for r, (data, st) in enumerate(ranks):
        x, x3, y = st["x"].clone(), st["x3"].clone(), st["y_ineq"].clone()
        ye = st["y_eq"].clone() if data["has_eq"] else x.new_zeros(0)
        packet, route = None, None
        if ndev > 1:
            mesh = types.SimpleNamespace(rank=r, size=ndev)
            arrays = (x, y, ye) if data["has_eq"] else (x, y)
            route = HaloRoute(mesh, arrays, scw.state_halo_items(
                data, dict(x=x, x3=x3, y_ineq=y, y_eq=ye)))
            route.pack()
            x, y = route.views[:2]
            ye = route.views[2] if data["has_eq"] else ye
            packet = route.packet
        step = stepper(data["shard"], data["pre"], x, x3, ye, y,
                       data["theta"], packet=packet)

        def counted(step=step):
            calls[0] += 1
            step()
        states.append(dict(x=x, x3=x3, y_ineq=y, y_eq=ye))
        routes.append(route)
        steps.append(counted)
    before = HaloRoute.launches
    for _ in range(nsteps):
        if ndev > 1:
            everyone = torch.cat([rt.packet for rt in routes])
            for rt in routes:
                rt.recv.copy_(everyone)
                rt.place()
        for step in steps:
            step()
    per_iteration = dict(placements=(HaloRoute.launches - before)
                         / (nsteps * ndev), entry_calls=calls[0]
                         / (nsteps * ndev))
    return _gathered(glob, [d for d, _ in ranks], states), per_iteration


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
@pytest.mark.parametrize("nan_case", [False, True], ids=["plain", "nan"])
def test_route_ranks_equal_chunk_twin(ndev, eq, nan_case):
    """On 1, 2 and 4 ranks, iterations of the shard entry's twin with the
    halos placed by the route (from the packets the twin writes) equal
    ``cp_dia_chunk_reference`` on the whole system bit for bit, NaN and
    signed zeros included; an iteration places the halos once (none on one
    rank) and calls the entry once."""
    glob = _glob(_sys(eq, nan_case), ndev)
    got, counts = _route_ranks(glob, ndev, torch.float32, "cpu", NSTEPS,
                               cp_dia.cp_dia_shard_stepper)
    nans, _ = assert_same_bits(got, _chunk_twin(glob, torch.float32, NSTEPS),
                               "route")
    assert (nans > 0) == nan_case
    assert counts == dict(placements=1.0 if ndev > 1 else 0.0,
                          entry_calls=1.0)


def test_route_index_places_only_halos():
    """The route's one index_copy_ writes rank - 1's right edges into the
    left halos and rank + 1's left edges into the right halos; every other
    received entry lands past the arrays, each in its own slot."""
    for size in (2, 3, 4):
        for rank in range(size):
            mesh = types.SimpleNamespace(rank=rank, size=size)
            a, b = torch.zeros(50), torch.zeros(50)
            items = [(a, 10, 40, 3, 2), (b, 10, 40, 7, 5)]
            route = HaloRoute(mesh, (a, b), items)
            k = route.packet.numel()
            assert k == 3 + 2 + 7 + 5
            route.recv.copy_(torch.arange(size * k, dtype=torch.float32)
                             + 1000)
            route.place()
            va, vb = route.views
            idx = route.index.tolist()
            assert len(set(idx)) == len(idx)
            assert route.flat.numel() == 100 + len(idx)
            prev = (rank - 1) * k + 1000
            nxt = (rank + 1) * k + 1000
            want_a, want_b = torch.zeros(50), torch.zeros(50)
            if rank > 0:
                want_a[7:10] = torch.arange(prev, prev + 3.0)
                want_b[3:10] = torch.arange(prev + 3, prev + 10.0)
            if rank < size - 1:
                want_a[40:42] = torch.arange(nxt + 10, nxt + 12.0)
                want_b[40:45] = torch.arange(nxt + 12, nxt + 17.0)
            assert torch.equal(va, want_a) and torch.equal(vb, want_b)


@pytest.mark.parametrize("world_size", [4])
def test_mesh_iteration_one_collective_two_launches(world_size):
    """gloo ranks (CPU): ``sharded_windowed_chunk`` issues, an iteration,
    one halo all-gather, one halo placement and one entry call, and its
    state equals the one-device chunk twin bit for bit."""
    sys_d = _sys(True, False)
    out = spawn(workers.run_cases, world_size, "gloo", "cpu",
                [("counts", "pos_counts", (sys_d, NSTEPS))])["counts"]
    glob = _glob(sys_d, world_size)
    # the gathered state comes as float64: float32's values, exactly
    assert_same_bits([torch.from_numpy(v).float() for v in out["state"]],
                     _chunk_twin(glob, torch.float32, NSTEPS), "mesh")
    assert out["per_iteration"] == dict(halo=1.0, placements=1.0,
                                        entry_calls=1.0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _twin_stepper(sh, pre, x, x3, y_eq, y, theta, sums=None, packet=None):
    """The twin as a stepper on any device's tensors."""
    return lambda: cp_dia.cp_dia_shard_step_reference(
        sh, pre, x, x3, y_eq, y, theta, sums, packet)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("eq", [False, True], ids=["ineq", "eq_ineq"])
@pytest.mark.parametrize("nan_case", [False, True], ids=["plain", "nan"])
def test_one_launch_entry_on_cuda(dtype, eq, nan_case):
    """The one-launch shard entry on 4 ranks' slices on the card, the halos
    placed by the route: 12 iterations equal the twin (on the card), the
    two-launch shard entry and the two-launch chunk entry bit for bit; one
    launch a call."""
    dev = cuda_or_skip()
    nsteps, glob = 12, _glob(_sys(eq, nan_case), 4)
    before = cp_dia.cp_dia_shard_step.launches
    got, counts = _route_ranks(glob, 4, dtype, dev, nsteps,
                               cp_dia.cp_dia_shard_stepper)
    assert cp_dia.cp_dia_shard_step.launches - before == 4 * nsteps
    assert counts == dict(placements=1.0, entry_calls=1.0)
    # the twin on the card's tensors: ATen's CUDA clamp is the one the
    # kernel rounds like (a NaN bound, a signed zero)
    twin, _ = _route_ranks(glob, 4, dtype, dev, nsteps, _twin_stepper)
    assert_same_bits(got, twin, "one-launch entry against the twin")
    ranks = [scw.place_position_shard(glob, 4, r, dtype, dev)
             for r in range(4)]
    for _ in range(nsteps):
        items = [scw.state_halo_items(d, st) for d, st in ranks]
        packets = [halo_pack(i) for i in items]
        for r, it in enumerate(items):
            halo_unpack(it, packets[r - 1] if r else None,
                        packets[r + 1] if r < 3 else None)
        for d, st in ranks:
            cp_dia.cp_dia_shard_step(
                d["shard"], d["pre"], st["x"], st["x3"],
                st.get("y_eq", st["x"].new_zeros(0)), st["y_ineq"], 1.0,
                two_launch=True)
    assert_same_bits(got, _gathered(glob, [d for d, _ in ranks],
                                    [st for _, st in ranks]),
                     "one-launch against two-launch entry")
    prob, pre, (x, ye, yi) = _whole(glob, dtype, dev)
    out = cp_dia.cp_dia_chunk(prob, pre, x, ye, yi, nsteps, 1.0,
                              plan=cp_dia.TWO_LAUNCH)
    want = [out[0], out[1]] + ([out[2]] if eq else []) + [out[3]]
    assert_same_bits(got, want, "one-launch entry against the chunk entry")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_launch_entry_packet_and_sums_on_cuda(dtype):
    """With running sums and a packet, on a middle rank of 4: the kernel's
    state, sums and packet equal the twin's (on the card) bit for bit over
    5 calls."""
    dev = cuda_or_skip()
    glob = _glob(_sys(True, True), 4)
    outs = []
    for stepper in (cp_dia.cp_dia_shard_stepper, _twin_stepper):
        data, st = scw.place_position_shard(glob, 4, 2, dtype, dev)
        sh = data["shard"]
        sums = tuple(torch.zeros_like(st[k]) for k in ("x", "y_eq",
                                                        "y_ineq"))
        packet = torch.full((sh.packet_size,), np.nan, dtype=dtype,
                            device=dev)
        step = stepper(sh, data["pre"], st["x"], st["x3"], st["y_eq"],
                       st["y_ineq"], 1.0, sums, packet)
        for _ in range(5):
            step()
        outs.append([st["x"], st["x3"], st["y_eq"], st["y_ineq"], *sums,
                     packet])
    assert_same_bits(outs[0], outs[1], "entry with sums and packet")
