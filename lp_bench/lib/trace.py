"""A ``torch.profiler`` trace of a run's window, read into intervals.

The profiler loses the first device records of a trace, the more the older
the process; so a trace starts with one replay of a CUDA graph of tiny
kernels whose records take the loss, and those are cut afterwards (a frozen
copy of the trick of ``pysparselp_tpu_torch.utils.instrumentation``).  The
Chrome trace is written to the run's temporary directory, read, and
deleted.  Times are in microseconds on the trace's clock.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

WARMUP_KERNELS = 4096
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "lp_bench."


def _warmup_graph():
    buf = torch.zeros(1, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(WARMUP_KERNELS):
            buf.add_(1.0)
    return graph, buf


def span(name: str):
    """A span of the harness's own, recorded in the trace as
    ``lp_bench.<name>`` (a no-op when nothing traces)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Context manager: traces its body when ``enabled``; ``.trace`` is the
    :class:`Trace` afterwards."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self._prof = None
        self._warm = None

    def __enter__(self):
        if not self.enabled:
            return self
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            self._warm = _warmup_graph()
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self._warm is not None:
            self._warm[0].replay()
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        if self._warm is not None:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="lp_bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(path)
        self._prof = None
        self.trace = Trace(cut_warmup(events))
        return False


def cut_warmup(events):
    """``events`` without the warm-up graph's launch and kernel records
    (those sharing the first ``cudaGraphLaunch``'s correlation id)."""
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "GraphLaunch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    if not launches:
        return events
    corr = launches[0].get("args", {}).get("correlation")
    return [e for e in events
            if e.get("args", {}).get("correlation") != corr
            and not (e.get("cat") == "ac2g" and e.get("id") == corr)]


class Trace:
    """Device and host intervals of a Chrome trace's complete events."""

    def __init__(self, events):
        dev, host, spans = [], [], {}
        launch_ts = {}
        kernel_corr = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            name = e.get("name", "")
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((t0, t1, name, cat))
                if cat == "kernel":
                    kernel_corr.append((corr, t0))
            elif cat in HOST_CATS:
                host.append((t0, t1, name))
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    launch_ts[corr] = t0
                if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                    spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                        (t0, t1))
        dev.sort()
        host.sort()
        self.device = dev
        self.host = host
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self.launch_of = {t: launch_ts.get(c) for c, t in kernel_corr}
        self._dev_starts = [d[0] for d in dev]

    @classmethod
    def from_intervals(cls, device=(), host=(), spans=None):
        """A trace from plain ``(start, end, name)`` intervals (tests)."""
        t = cls([])
        t.device = sorted((a, b, n, "kernel") for a, b, n in device)
        t.host = sorted(host)
        t.spans = {k: sorted(v) for k, v in (spans or {}).items()}
        t.launch_of = {}
        t._dev_starts = [d[0] for d in t.device]
        return t

    def device_in(self, t0, t1, pattern=None):
        """Device records that overlap ``[t0, t1]`` (names matching the
        regular expression ``pattern``, when given), clipped to it."""
        rx = re.compile(pattern) if pattern else None
        i = max(bisect.bisect_left(self._dev_starts, t0) - 64, 0)
        out = []
        for a, b, name, cat in self.device[i:]:
            if a > t1:
                break
            if b < t0 or (rx is not None and not rx.search(name)):
                continue
            out.append((max(a, t0), min(b, t1), name, cat))
        return out

    def busy(self, t0, t1):
        """Microseconds of ``[t0, t1]`` in which some device record ran."""
        return t1 - t0 - sum(b - a for a, b in self.gaps(t0, t1))

    def gaps(self, t0, t1):
        """The idle intervals of ``[t0, t1]``: no device record runs."""
        out, cur = [], t0
        for a, b, _, _ in self.device_in(t0, t1):
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if cur < t1:
            out.append((cur, t1))
        return out

    def host_at(self, t):
        """The innermost host record running at ``t`` (the one that began
        last among those covering it), or ``"python"`` where none does."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = None
        for a, b, name in reversed(self.host[max(i - 4096, 0):i]):
            if b >= t:
                best = name
                break
        if best is None:
            inner = [(a, k) for k, v in self.spans.items() for a, b in v
                     if a <= t <= b]
            best = SPAN_PREFIX + max(inner)[1] if inner else "python"
        return best

    def device_ops(self, t0, t1, top=10):
        """``[[name, seconds], ...]``: the device operations that took most
        time in ``[t0, t1]``."""
        tot = {}
        for a, b, name, _ in self.device_in(t0, t1):
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, t0, t1, top=10):
        """``[[host activity, seconds], ...]``: the longest idle gaps of
        ``[t0, t1]``, each named by what the host was doing at its middle."""
        gaps = sorted(self.gaps(t0, t1), key=lambda g: g[0] - g[1])[:top]
        return [[self.host_at(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps]
