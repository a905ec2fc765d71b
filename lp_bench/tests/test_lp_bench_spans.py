"""The readers of the program's spans (``lib/spans.py`` and the metrics
built on it) on synthetic traces with known spans and idle gaps, and on a
tiny traced run on the CPU."""

import pytest

from lp_bench.lib import spans, spec
from lp_bench.lib.trace import Trace
from lp_bench.tests.helpers import run_cpu, tiny_cell
from lp_bench.tests.test_lp_bench_trace import FakeRun, ctx_of

PRESOLVE = ("presolve_reduce_s.solve", "presolve_layout_s.solve",
            "presolve_lower_s.solve")
SOLVE_READERS = PRESOLVE + ("postsolve_ms.solve", "syncs_per_checkpoint.solve")


def _solve(t, reduce, layout, lower, syncs, post):
    """The program's spans of one solve starting at ``t``: the presolve
    stages of the given lengths, a chunk, a checkpoint holding
    ``syncs`` reads, then a postsolve of ``post`` µs holding one read and
    one of 10 µs."""
    out = [(t + 10, t + 990, "pslp.solve")]
    a = t + 20
    for name, n in (("reduce", reduce), ("layout", layout), ("lower", lower)):
        out.append((a, a + n, f"pslp.presolve.{name}"))
        a += n
    out += [(a, a + 50, "pslp.cp.chunk"),
            (a + 50, a + 150, "pslp.cp.checkpoint")]
    out += [(a + 60 + 10 * i, a + 65 + 10 * i, "pslp.sync")
            for i in range(syncs)]
    a += 150
    out += [(a, a + post, "pslp.postsolve"), (a + 1, a + 5, "pslp.sync"),
            (a + post + 5, a + post + 15, "pslp.postsolve")]
    return out


def _closed_loop(with_spans=True, kind="closed_loop"):
    host = (_solve(0, 100, 200, 300, 2, 50)
            + _solve(2000, 300, 100, 100, 3, 90)) if with_spans else []
    host.append((100, 110, "aten::add"))
    t = Trace.from_intervals(device=[(700, 720, "k"), (2700, 2720, "k")],
                             host=host,
                             spans={"solve": [(0, 1000), (2000, 3000)]})
    solves = [{"curves": {"itrn": [1, 2]}}, {"curves": {"itrn": [1]}}]
    return ctx_of(FakeRun(kind, {}, {}, solves=solves), t, (0, 3000))


def test_solve_readers():
    ctx = _closed_loop()
    read = {m: spec.metric_reader(m)(ctx) for m in SOLVE_READERS}
    assert read["presolve_reduce_s.solve"] == pytest.approx(200e-6)
    assert read["presolve_layout_s.solve"] == pytest.approx(150e-6)
    assert read["presolve_lower_s.solve"] == pytest.approx(200e-6)
    assert read["postsolve_ms.solve"] == pytest.approx((60 + 100) / 2 * 1e-3)
    # (2 + 1) + (3 + 1) reads over 3 checkpoints
    assert read["syncs_per_checkpoint.solve"] == pytest.approx(7 / 3)


@pytest.mark.parametrize("ctx", [_closed_loop(with_spans=False),
                                 _closed_loop(kind="single_solve")],
                         ids=["no_program_spans", "other_kind"])
def test_solve_readers_find_nothing(ctx):
    for m in SOLVE_READERS:
        assert spec.metric_reader(m)(ctx) is None, m


@pytest.mark.parametrize("kind, metric, name", [
    ("single_solve", "chunk_idle_ms.rate", "pslp.cp.chunk"),
    ("batch", "chunk_idle_ms.batch", "pslp.batch.chunk")])
def test_chunk_idle_counts_only_idle_inside_chunks(kind, metric, name):
    """Idle inside the chunk spans within the measured span (100, 1100),
    per checkpoint interval (2): a gap straddling a span's edge counts
    only inside it, a span straddling the segment's edge only inside
    that."""
    device = [(0, 150, "k"), (180, 400, "k"), (450, 600, "k"),
              (700, 1050, "k"), (1080, 1200, "k")]
    chunks = [(0, 50), (140, 420), (600, 720), (1040, 1150)]
    host = [(a, b, name) for a, b in chunks] + [
        (420, 440, "pslp.cp.checkpoint"), (430, 435, "pslp.sync")]
    t = Trace.from_intervals(device=device, host=host)
    run = FakeRun(kind, {}, {}, last=2)
    # (150, 180) whole, (400, 420) of (400, 450), (600, 700), (1050, 1080)
    idle = 30 + 20 + 100 + 30
    assert spec.metric_reader(metric)(ctx_of(run, t, (100, 1100))) == \
        pytest.approx(idle * 1e-3 / 2)
    empty = Trace.from_intervals(device=device)
    assert spec.metric_reader(metric)(ctx_of(run, empty, (100, 1100))) is None
    other = FakeRun("closed_loop", {}, {}, last=2)
    assert spec.metric_reader(metric)(ctx_of(other, t, (100, 1100))) is None


def test_idle_coverage_and_clock_agreement():
    device = [(0, 100, "k"), (200, 300, "k"), (400, 500, "k"),
              (600, 700, "k")]
    host = [(0, 1000, "pslp.solve"), (50, 250, "pslp.cp.chunk"),
            (250, 450, "pslp.cp.checkpoint"), (300, 420, "pslp.sync"),
            (520, 560, "pslp.sync"),          # inside the root alone
            (640, 660, "pslp.sync")]          # ends 40 µs before 700
    t = Trace.from_intervals(device=device, host=host)
    covered, idle = spans.idle_covered(t, 0, 800)
    # gaps (100, 200), (300, 400), (500, 600), (700, 800); stages cover
    # all of the first two and (520, 560) of the third
    assert idle == pytest.approx(400)
    assert covered == pytest.approx(100 + 100 + 40)
    assert spans.sync_clock_agreement(t) == (3, 3)
    assert spans.sync_clock_agreement(t, slack_us=30.0) == (2, 3)


def test_tiny_traced_run_reads_the_program_spans_on_the_cpu():
    """A traced tiny to_tol run on the CPU: the presolve stages, the
    postsolve and the reads per checkpoint come from the program's own
    spans (no device needed); in light metrics with a stop test a
    checkpoint reads 5 times in the loop and 3 after it, a solve once
    more for its final x."""
    result = run_cpu(tiny_cell("potts300.to_tol"), seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for m in SOLVE_READERS:
        assert got[m] > 0, m
    assert 8 < got["syncs_per_checkpoint.solve"] <= 9
