"""The metric arithmetic on synthetic traces: busy and idle time, idle
gaps and what the host did, launches per iteration, roofline shares,
presolve seconds and the controller's idle time."""

import numpy as np
import pytest

from lp_bench.lib import roofline, spec
from lp_bench.lib.harness import RunContext
from lp_bench.lib.trace import Trace, cut_warmup
from lp_bench.reference import potts as ref

PEAK = roofline.peak("NVIDIA H100 80GB HBM3")


class FakeRun:
    def __init__(self, kind, config, traffic, **kw):
        self.traffic = dict(traffic, kind=kind)
        self.cell = type("C", (), {"config": config})()
        self.__dict__.update(kw)


def ctx_of(run, trace, segment):
    return RunContext(run, trace, segment, PEAK)


def test_busy_gaps_and_idle_share():
    t = Trace.from_intervals(
        device=[(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (90, 100, "c")],
        host=[(0, 100, "lp_bench.solve"), (20, 30, "aten::fill_"),
              (40, 90, "cudaStreamSynchronize")],
        spans={"solve": [(0, 100)]})
    assert t.busy(0, 100) == pytest.approx(40)
    assert t.gaps(0, 100) == [(20, 30), (40, 90)]
    gaps = t.idle_gaps(0, 100)
    assert [g[0] for g in gaps] == ["cudaStreamSynchronize", "aten::fill_"]
    assert [g[1] for g in gaps] == pytest.approx([50e-6, 10e-6])
    ops = dict(t.device_ops(0, 100))
    assert ops == pytest.approx({"a": 20e-6, "b": 15e-6, "c": 10e-6})
    run = FakeRun("single_solve", {}, {})
    assert spec.metric_reader("idle_share.rate")(ctx_of(run, t, (0, 100))) \
        == pytest.approx(60.0)
    assert spec.metric_reader("idle_share.batch")(ctx_of(run, t, (0, 100))) \
        is None


def test_host_activity_falls_back_to_the_harness_span():
    t = Trace.from_intervals(device=[(0, 1, "k"), (50, 51, "k")],
                             host=[(0, 2, "aten::add")],
                             spans={"window": [(0, 60)]})
    (name, sec), = t.idle_gaps(0, 51)
    assert name == "lp_bench.window" and sec == pytest.approx(49e-6)


def test_launches_per_iteration_and_spmm_roofline():
    size, bsz = 20, 4
    cfg = {"image_size": size, "dtype": "float32"}
    itrn = np.array([10, 20, 30])
    kernels = []
    for it in range(20):   # 20 iterations after the first checkpoint
        base = 100 + 10 * it
        kernels += [(base, base + 2, "csr_batch_kernel<float>"),
                    (base + 3, base + 4, "elementwise"),
                    (base + 5, base + 7, "csr_batch_kernel<float>")]
    t = Trace.from_intervals(device=kernels)
    run = FakeRun("batch", cfg, {"batch": bsz}, curves={"itrn": itrn},
                  last=2)
    c = ctx_of(run, t, (100, 300))
    assert spec.metric_reader("launches_per_iter.batch")(c) == 3.0
    nnz, n, m = ref.lp_dims(size, size)
    a_x = roofline.spmm_least_seconds(nnz, m, n, bsz, 4, PEAK)
    at_y = roofline.spmm_least_seconds(nnz, n, m, bsz, 4, PEAK)
    least = 20 * (a_x + at_y) + 2 * (at_y + 2 * a_x)
    busy = 20 * 4e-6
    assert spec.metric_reader("spmm_roofline.batch")(c) == \
        pytest.approx(100 * least / busy)


def _cp_ctx(kernels, chunks, size=500):
    t = Trace.from_intervals(device=kernels)
    itrn = np.cumsum([chunks[0]] + chunks)
    run = FakeRun("single_solve", {"image_size": size, "dtype": "float32"},
                  {}, chunks=lambda: chunks, curves={"itrn": itrn},
                  last=len(chunks))
    return ctx_of(run, t, (0, 1e6))


def test_cp_roofline_holds_every_tier_to_the_same_work():
    """Potts-500: the grid tier (one launch a chunk) and the two-launch tier
    (two a iteration) doing the same iterations in the same device time
    read the same share; the work is counted from the LP alone."""
    chunks = [2000, 2000]
    grid = [(0, 100_000, "void cp_dia_grid_kernel<float, __nv_bfloat16>"),
            (200_000, 300_000, "void cp_dia_grid_kernel<float, __nv_bfloat16>")]
    per_launch = 200_000 / (2 * 4000)
    two = []
    for i in range(2 * 4000):
        a = 400_000 + i * 30
        two.append((a, a + per_launch, "void cp_primal_kernel<float>"
                    if i % 2 == 0 else "void cp_dual_kernel<float>"))
    read = spec.metric_reader("cp_roofline")
    share_grid = read(_cp_ctx(grid + [(150_000, 150_010, "other")], chunks))
    share_two = read(_cp_ctx(two, chunks))
    assert share_grid == pytest.approx(share_two)
    nnz, n, m = ref.lp_dims(500, 500)
    lp = ref.PottsLP(500, 500, 0.5, 500)
    assert (nnz, n, m) == (lp.matrix.nnz, lp.n, lp.m) == (2994000, 749000,
                                                          998000)
    ops = roofline.cp_iteration_ops(nnz, n, m)
    byts = roofline.cp_chunk_bytes(nnz, n, m, 4)
    least = sum(max(k * ops / 67e12, byts / 3.35e12) for k in chunks)
    assert share_grid == pytest.approx(100 * least / 0.2)


def test_solve_readers():
    cp = "void cp_dia_grid_kernel<float, __nv_bfloat16>"
    t = Trace.from_intervals(
        device=[(1000, 1100, cp), (1300, 1400, cp), (3000, 3050, cp)],
        spans={"solve": [(0, 1500), (2000, 3100)]})
    t.launch_of = {1000: 900, 3000: 2950}
    solves = [{"curves": {"itrn": [1, 2]}}, {"curves": {"itrn": [1]}}]
    run = FakeRun("closed_loop", {}, {}, solves=solves)
    c = ctx_of(run, t, (0, 3100))
    assert spec.metric_reader("presolve_s.solve")(c) == \
        pytest.approx((900e-6 + 950e-6) / 2)
    idle = (200 + 100) + 50     # after each solve's first chunk kernel
    assert spec.metric_reader("controller_idle_ms.solve")(c) == \
        pytest.approx(idle * 1e-3 / 3)


def test_chrome_events_and_the_warmup_cut():
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 0, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "warm", "ts": 6, "dur": 1,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": "lp_bench.solve",
         "ts": 10, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20, "dur": 3, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "cp_dia_grid_kernel", "ts": 30,
         "dur": 50, "args": {"correlation": 9}},
    ]
    t = Trace(cut_warmup(events))
    assert [d[2] for d in t.device] == ["cp_dia_grid_kernel"]
    assert t.spans == {"solve": [(10.0, 110.0)]}
    assert t.launch_of == {30.0: 20.0}
    assert t.busy(10, 110) == pytest.approx(50)
