"""The program's own spans in a trace, for the readers that split a layer
by them, and the checks of them that ``scripts/probe_spans.py`` runs.

``pysparselp_tpu_torch.utils.instrumentation.span`` marks each stage of a
solve as a ``record_function`` range named ``pslp.<stage>``: on the
trace's clock, among the host records (``Trace.host``).  Roots are
``pslp.solve`` (one ``SparseLP.solve``) and ``pslp.batch`` (one
``solve_cp_batch``); every other span lies inside one, and ``pslp.sync``
(a blocking device read) inside a stage.  A program without spans gives
none here, and the readers built on them return None.
"""

from __future__ import annotations

import bisect

from . import readers

PREFIX = "pslp."
ROOTS = ("solve", "batch")


class ProgramSpans:
    """A trace's program spans by name (without the prefix), each name's
    ``(start, end)`` pairs sorted by start."""

    def __init__(self, trace):
        found = {}
        for a, b, name in trace.host:
            if name.startswith(PREFIX):
                found.setdefault(name[len(PREFIX):], []).append((a, b))
        self._spans = found
        self._starts = {k: [a for a, _ in v] for k, v in found.items()}

    def names(self):
        return list(self._spans)

    def within(self, name, t0=float("-inf"), t1=float("inf")):
        """``(start, end)`` of each span ``pslp.<name>`` inside
        ``[t0, t1]``."""
        spans = self._spans.get(name, [])
        i = bisect.bisect_left(self._starts.get(name, []), t0)
        out = []
        for a, b in spans[i:]:
            if a > t1:
                break
            if b <= t1:
                out.append((a, b))
        return out

    def clipped(self, name, t0, t1):
        """Each span ``pslp.<name>`` that overlaps ``[t0, t1]``, cut to
        it."""
        spans = self._spans.get(name, [])
        end = bisect.bisect_right(self._starts.get(name, []), t1)
        return [(max(a, t0), min(b, t1)) for a, b in spans[:end] if b > t0]


def traced_solves(ctx, spans):
    """``(span, solve)`` pairs of a closed loop's solves in which the
    program emitted its root span."""
    return [((a, b), s) for (a, b), s in readers.solve_spans(ctx)
            if spans.within("solve", a, b)]


def stage_seconds(ctx, name):
    """Seconds in spans ``pslp.<name>`` a solve, the mean over a closed
    loop's traced solves (else None)."""
    if ctx.kind != "closed_loop":
        return None
    spans = ProgramSpans(ctx.trace)
    per = [sum(b - a for a, b in spans.within(name, *span)) * 1e-6
           for span, _ in traced_solves(ctx, spans)]
    return sum(per) / len(per) if per else None


def idle_inside(ctx, kind, name):
    """Milliseconds the card idles inside spans ``pslp.<name>`` within the
    measured span, per checkpoint interval of it, for runs of traffic
    kind ``kind`` (else None)."""
    if ctx.kind != kind or ctx.run.last < 1:
        return None
    t0, t1 = ctx.segment
    found = ProgramSpans(ctx.trace).clipped(name, t0, t1)
    if not found or not ctx.trace.device_in(t0, t1):
        return None
    idle = sum(g1 - g0 for a, b in found for g0, g1 in ctx.trace.gaps(a, b))
    return idle * 1e-3 / ctx.run.last


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_covered(trace, t0, t1):
    """``(covered, idle)``: microseconds of ``[t0, t1]`` with no device
    record running, and of those the ones inside some program span other
    than a root (a stage, or a span inside one)."""
    spans = ProgramSpans(trace)
    stages = _union(s for name in spans.names() if name not in ROOTS
                    for s in spans.clipped(name, t0, t1))
    gaps = trace.gaps(t0, t1)
    covered, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(stages) and stages[j][1] <= g0:
            j += 1
        k = j
        while k < len(stages) and stages[k][0] < g1:
            covered += min(g1, stages[k][1]) - max(g0, stages[k][0])
            k += 1
    return covered, sum(g1 - g0 for g0, g1 in gaps)


def sync_clock_agreement(trace, slack_us=50.0):
    """``(agreeing, syncs)``: of the ``pslp.sync`` spans that follow some
    device record, those that end no earlier than the end of the last
    device record started before the span began, less ``slack_us``.  A
    read waits for the work queued before it, so a sync that ends before
    that work ended would mean the host and device clocks disagree."""
    starts = [d[0] for d in trace.device]
    agree = total = 0
    for a, b in ProgramSpans(trace).within("sync"):
        i = bisect.bisect_left(starts, a) - 1
        if i < 0:
            continue
        total += 1
        agree += b >= trace.device[i][1] - slack_us
    return agree, total
