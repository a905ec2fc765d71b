"""The port's observability layer on the CPU in float64: checkpoints
(``checkpoint.py``, verbatim), ``SolutionStat`` / ``save_arguments``
(``utils/instrumentation.py``), ``debug_mode`` (``utils/debug.py``: a
chunk-boundary trap), ``profile_trace`` (``torch.profiler``) and the
benchmark driver (``benchmarks.py``, verbatim): the counterparts of
``tests/test_instrumentation.py``, a checkpoint written by either package
resumed in the other, and ``debug_mode`` raising in both packages on the
same NaN-cost LP."""

import json
import os

import numpy as np
import pytest
import torch

import pysparselp_tpu as jpkg
from pysparselp_tpu.utils.random_lp import generate_random_lp as jax_random
from pysparselp_tpu_torch import (
    CheckpointingCallback,
    load_checkpoint,
    save_checkpoint,
)
from pysparselp_tpu_torch.benchmarks import plot_results, run_solvers
from pysparselp_tpu_torch.utils import (
    SolutionStat,
    assert_all_finite,
    debug_mode,
    load_arguments,
    profile_trace,
    save_arguments,
)
from pysparselp_tpu_torch.utils.random_lp import generate_random_lp

torch.set_num_threads(1)
CP = "chambolle_pock_ppd"
CPU = {"device": "cpu"}
# between the two packages, as tests/test_torch_slice.py holds them
RTOL = ATOL = 1e-9
LP_KW = dict(nbvar=25, n_eq=2, n_ineq=25, sparsity=0.25, seed=2)


@pytest.fixture(scope="module")
def lp():
    return generate_random_lp(**LP_KW)[0]


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "state.npz")
    x = np.arange(5.0)
    save_checkpoint(p, x, y_eq=np.ones(2), niter=42, meta={"energy1": 3.5})
    st = load_checkpoint(p)
    np.testing.assert_array_equal(st["x"], x)
    np.testing.assert_array_equal(st["y_eq"], np.ones(2))
    assert st["y_ineq"] is None
    assert st["niter"] == 42
    assert float(st["meta"]["energy1"]) == 3.5


def test_checkpointing_callback_and_resume(lp, tmp_path):
    """Full-state checkpoint mid-solve, resume through lp.solve, and match
    the uninterrupted trajectory exactly (same chunk boundaries)."""
    x_full, _ = lp.solve(method=CP, nb_iter=800, nb_iter_plot=200, **CPU)

    p = str(tmp_path / "cp.npz")
    ckpt = CheckpointingCallback(p, every_sec=0.0)  # checkpoint every tick
    lp.solve(method=CP, nb_iter=400, nb_iter_plot=200,
             callback_func=ckpt.wrap(None), **CPU)
    assert os.path.exists(p)
    st = load_checkpoint(p)
    assert st["niter"] == 400
    assert st["y_eq"] is not None and st["y_ineq"] is not None
    assert "x3" in st["meta"]

    x_res, _ = lp.solve(method=CP, nb_iter=400, nb_iter_plot=200,
                        x0=st["x"], y_eq0=st["y_eq"], y_ineq0=st["y_ineq"],
                        x30=st["meta"]["x3"], **CPU)
    np.testing.assert_allclose(x_res, x_full, atol=1e-9)


def test_warm_start_is_used_through_dispatch(lp):
    """x0 reaches the solver through dispatch: a warm and a cold run
    differ."""
    ref, _ = lp.solve(method="scipy_simplex")
    warm, _ = lp.solve(method=CP, nb_iter=100, nb_iter_plot=100, x0=ref,
                       **CPU)
    cold, _ = lp.solve(method=CP, nb_iter=100, nb_iter_plot=100, **CPU)
    assert np.max(np.abs(warm - cold)) > 1e-8


def test_full_state_resume_with_fixed_variables(tmp_path):
    """Resume survives remove_fixed_variables' reduced-space mapping."""
    lp, _ = generate_random_lp(nbvar=25, n_eq=2, n_ineq=25, sparsity=0.25,
                               seed=7)
    lp.upper_bounds[:3] = lp.lower_bounds[:3]
    x_full, _ = lp.solve(method=CP, nb_iter=600, nb_iter_plot=200, **CPU)

    p = str(tmp_path / "cp.npz")
    ckpt = CheckpointingCallback(p, every_sec=0.0)
    lp.solve(method=CP, nb_iter=200, nb_iter_plot=200, callback_func=ckpt,
             **CPU)
    st = load_checkpoint(p)
    x_res, _ = lp.solve(method=CP, nb_iter=400, nb_iter_plot=200,
                        x0=st["x"], y_eq0=st["y_eq"], y_ineq0=st["y_ineq"],
                        x30=st["meta"]["x3"], **CPU)
    np.testing.assert_allclose(x_res, x_full, atol=1e-9)
    np.testing.assert_allclose(x_res[:3], lp.lower_bounds[:3], atol=1e-9)


def test_solution_stat_records(lp):
    stat = SolutionStat(lp)
    lp.solve(method=CP, nb_iter=300, nb_iter_plot=100, callback_func=stat,
             **CPU)
    assert stat.iterations == [100, 200, 300]
    assert len(stat.costs) == 3
    assert stat.summary()["niter"] == 300
    assert np.isfinite(stat.summary()["final_cost"])


def test_save_load_arguments(tmp_path):
    p = str(tmp_path / "args.pkl")

    def solver_entry(c, a, tol=1e-3):
        save_arguments(p)
        return c

    solver_entry(np.ones(3), "matrix", tol=0.5)
    st = load_arguments(p)
    np.testing.assert_array_equal(st["c"], np.ones(3))
    assert st["a"] == "matrix"
    assert st["tol"] == 0.5


def test_debug_mode_and_assert_finite():
    from pysparselp_tpu_torch.utils import debug

    assert not debug.debug_enabled()
    with debug_mode(nans=True):
        assert debug._FLAGS == {"nans": True, "infs": False}
        with debug_mode(nans=False, infs=True):
            assert debug._FLAGS == {"nans": False, "infs": True}
        assert debug._FLAGS == {"nans": True, "infs": False}
    assert not debug.debug_enabled()
    assert_all_finite("ok", np.ones(3))
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_all_finite("bad", np.array([1.0, np.nan]))


def test_check_iterate_flags():
    """The chunk-boundary check: a no-op that touches nothing with the
    flag off (an object no tensor can be made of passes), NaN trapped with
    ``nans``, infinities only with ``infs``."""
    from pysparselp_tpu_torch.utils.debug import check_iterate

    check_iterate("s", 1, x=object())
    nan, inf = torch.tensor([0.0, np.nan]), np.array([1.0, np.inf])
    with debug_mode():
        with pytest.raises(FloatingPointError,
                           match=r"^s: iteration 7: x has 1/2 NaN"):
            check_iterate("s", 7, y=np.ones(2), x=nan)
        check_iterate("s", 7, x=inf, e=float("inf"))
    with debug_mode(nans=False, infs=True):
        check_iterate("s", 7, x=nan)
        with pytest.raises(FloatingPointError, match="1/1 infinite"):
            check_iterate("s", 7, e=float("-inf"))


def test_benchmark_driver_and_plot(lp, tmp_path):
    gt, _ = lp.solve(method="scipy_simplex")
    results = run_solvers(
        lp, ground_truth=gt,
        methods=[CP, "dual_gradient_ascent"],
        nb_iter=300, nb_iter_plot=100, max_time=30.0, verbose=False,
        solve_kwargs=CPU,
    )
    assert set(results) == {CP, "dual_gradient_ascent"}
    for r in results.values():
        assert "error" not in r
        assert len(r["itrn_curve"]) == 3
        assert len(r["distance_to_ground_truth"]) == 3
    fig = plot_results(results, show=False,
                       save_path=str(tmp_path / "bench.png"))
    assert fig is not None
    assert (tmp_path / "bench.png").exists()


def test_linear_solve_wrappers():
    import scipy.sparse

    from pysparselp_tpu_torch.ops.linear_solve import (
        CgSolver,
        DenseCholesky,
        make_spd_solver,
    )

    rng = np.random.RandomState(0)
    a = rng.randn(30, 30)
    m = a @ a.T + 30 * np.eye(30)
    b = rng.randn(30)
    ref = np.linalg.solve(m, b)
    bt = torch.as_tensor(b)

    dc = DenseCholesky(m, device="cpu")
    np.testing.assert_allclose(dc.solve(b).numpy(), ref, atol=1e-8)

    sp = scipy.sparse.csr_matrix(m)
    s = make_spd_solver(sp, device="cpu")
    np.testing.assert_allclose(s.solve(b).numpy(), ref, atol=1e-8)

    mt = torch.as_tensor(m)
    cg = CgSolver(lambda v: mt @ v, diag=np.diag(m), maxiter=300)
    np.testing.assert_allclose(cg.solve(bt).numpy(), ref, atol=1e-6)

    big = make_spd_solver(sp, dense_max_dim=10, diag=torch.as_tensor(
        np.diag(m).copy()), device="cpu")
    np.testing.assert_allclose(big.solve(bt).numpy(), ref, atol=1e-6)


def test_benchmark_random_lp_harness():
    from pysparselp_tpu_torch.benchmarks import benchmark_random_lp

    results, lp = benchmark_random_lp(
        nbvar=20, n_eq=2, n_ineq=20, sparsity=0.3, seed=2,
        methods=[CP, "admm2"],
        nb_iter=400, nb_iter_plot=200, max_time=30.0, verbose=False,
        solve_kwargs=CPU,
    )
    assert set(results) == {CP, "admm2"}
    for r in results.values():
        assert np.isfinite(r["cost"]) and len(r["itrn_curve"]) == 2
        assert r["distance_to_ground_truth"][-1] < 10.0


# ----------------------------------------------------------------------
# across the two packages
# ----------------------------------------------------------------------


def _resume(lp, st, **kw):
    x, _ = lp.solve(method=CP, nb_iter=400, nb_iter_plot=200, x0=st["x"],
                    y_eq0=st["y_eq"], y_ineq0=st["y_ineq"],
                    x30=st["meta"]["x3"], **kw)
    return x


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint the JAX package writes at iteration 400 of a CP solve
    resumes in the port: the port's 400 more iterations match the port's
    800-iteration straight run and JAX's."""
    lp_j, lp_p = jax_random(**LP_KW)[0], generate_random_lp(**LP_KW)[0]
    p = str(tmp_path / "jax.npz")
    lp_j.solve(method=CP, nb_iter=400, nb_iter_plot=200,
               callback_func=jpkg.CheckpointingCallback(p, 0.0).wrap(None))
    st = load_checkpoint(p)
    assert st["niter"] == 400
    x_res = _resume(lp_p, st, **CPU)
    x_port, _ = lp_p.solve(method=CP, nb_iter=800, nb_iter_plot=200, **CPU)
    x_jax, _ = lp_j.solve(method=CP, nb_iter=800, nb_iter_plot=200)
    np.testing.assert_allclose(x_res, x_port, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x_res, x_jax, rtol=RTOL, atol=ATOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The reverse: the port writes at iteration 400, the JAX package loads
    it with its own ``load_checkpoint`` and resumes; both straight runs
    match."""
    lp_j, lp_p = jax_random(**LP_KW)[0], generate_random_lp(**LP_KW)[0]
    p = str(tmp_path / "port.npz")
    lp_p.solve(method=CP, nb_iter=400, nb_iter_plot=200,
               callback_func=CheckpointingCallback(p, 0.0).wrap(None), **CPU)
    st = jpkg.load_checkpoint(p)
    assert st["niter"] == 400
    x_res = _resume(lp_j, st)
    x_port, _ = lp_p.solve(method=CP, nb_iter=800, nb_iter_plot=200, **CPU)
    x_jax, _ = lp_j.solve(method=CP, nb_iter=800, nb_iter_plot=200)
    np.testing.assert_allclose(x_res, x_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x_res, x_port, rtol=RTOL, atol=ATOL)


def _nan_cost_lp(make):
    """A Potts-10 LP whose cost vector holds one NaN (neither package's
    host layer refuses it before the first chunk)."""
    lp = make(10, 0.5, 500, seed=1)[0]
    lp.costsvector[3] = np.nan
    return lp


def test_debug_mode_traps_nan_in_both_packages():
    """Under ``debug_mode`` both packages raise ``FloatingPointError`` on
    the same NaN-cost LP (JAX at the op that made the NaN, the port at the
    first chunk boundary after it, naming the solver and the iteration);
    without it the port returns, its iterate NaN."""
    from pysparselp_tpu.examples.potts import build_linear_program as jbuild
    from pysparselp_tpu.utils import debug_mode as jax_debug_mode
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    run = dict(method=CP, nb_iter=400, nb_iter_plot=200)
    with jax_debug_mode():
        with pytest.raises(FloatingPointError):
            _nan_cost_lp(jbuild).solve(**run)
    lp = _nan_cost_lp(build_linear_program)
    with debug_mode():
        with pytest.raises(FloatingPointError,
                           match=r"chambolle_pock_ppd: iteration 200: x has"):
            lp.solve(**run, **CPU)
    x, _ = lp.solve(**run, **CPU)
    assert x.shape == (lp.nb_variables,) and np.isnan(x).any()


@pytest.mark.parametrize("method", ["admm", "admm2", "admm_blocks",
                                    "dual_gradient_ascent", "mehrotra"])
def test_debug_mode_traps_every_device_solver(method):
    """Each device solver's chunk-boundary check names its solver
    function; the flag off, the same solve returns."""
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    function = {"admm": "lp_admm", "admm2": "lp_admm2",
                "admm_blocks": "lp_admm_block_decomposition"}.get(method,
                                                                  method)
    lp = _nan_cost_lp(build_linear_program)
    run = dict(method=method, nb_iter=40, nb_iter_plot=20, **CPU)
    with debug_mode():
        with pytest.raises(FloatingPointError,
                           match=f"^{function}: iteration"):
            lp.solve(**run)
    lp.solve(**run)


def test_debug_mode_traps_batch():
    """``solve_cp_batch`` checks its iterate and curves at each
    checkpoint: one NaN cost among the batch's traps under ``debug_mode``
    and returns without it."""
    from pysparselp_tpu_torch import solve_cp_batch
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp = build_linear_program(6, 0.5, 500, seed=1)[0]
    costs = np.tile(lp.costsvector, (3, 1))
    costs[1, 3] = np.nan
    run = dict(costs=costs, nb_iter=40, nb_iter_plot=20, device="cpu")
    with debug_mode():
        with pytest.raises(FloatingPointError,
                           match=r"^solve_cp_batch: iteration 20: x has"):
            solve_cp_batch(lp, **run)
    x, _info = solve_cp_batch(lp, **run)
    assert np.isnan(x[1]).any() and np.isfinite(x[0]).all()


def test_profile_trace_on_cpu(lp, tmp_path):
    """``profile_trace`` yields its directory and writes a Chrome trace
    there that holds the solve's CPU ops."""
    d = str(tmp_path / "trace")
    with profile_trace(d) as log_dir:
        lp.solve(method=CP, nb_iter=20, nb_iter_plot=10, **CPU)
    assert log_dir == d
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert any(n.startswith("aten::") for n in names if n), sorted(names)[:20]
    with profile_trace(enabled=False) as none:
        assert none is None


def test_profile_trace_default_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profile_trace() as log_dir:
        torch.ones(3).sum()
    assert os.path.dirname(log_dir) == str(tmp_path)
    assert os.path.basename(log_dir).startswith("torch_trace_")
    assert os.path.isfile(os.path.join(log_dir, "trace.json"))


def _trace_with_warmup(path, warmup_kernels):
    """A Chrome trace with a warm-up graph launch (correlation 7) holding
    ``warmup_kernels`` kernel records, then a run's launch and kernel."""
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 10.0, "dur": 1.0, "args": {"correlation": 7}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 7, "ts": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20.0, "dur": 1.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "run_kernel", "ts": 22.0,
         "dur": 3.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 19.0,
         "dur": 3.0, "args": {}},
    ] + [{"ph": "X", "cat": "kernel", "name": "warmup_add", "ts": 11.0 + i,
          "dur": 0.5, "args": {"correlation": 7}}
         for i in range(warmup_kernels)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "deviceProperties": []}, f)


@pytest.mark.parametrize("warmup_kernels", [3, 0])
def test_cut_warmup(tmp_path, warmup_kernels):
    """``cut_warmup`` removes the warm-up graph's launch, kernels and flow
    arrow and nothing else, returns how many of its kernel records the
    trace held, and warns when it held none."""
    from pysparselp_tpu_torch.utils.instrumentation import cut_warmup

    path = str(tmp_path / "trace.json")
    _trace_with_warmup(path, warmup_kernels)
    if warmup_kernels:
        kept = cut_warmup(path)
    else:
        with pytest.warns(UserWarning, match="none of the"):
            kept = cut_warmup(path)
    assert kept == warmup_kernels
    with open(path) as f:
        trace = json.load(f)
    assert [e["name"] for e in trace["traceEvents"]] == [
        "cudaLaunchKernel", "run_kernel", "aten::add"]
    assert trace["deviceProperties"] == []
    assert cut_warmup(path) == 0  # no graph launch left: nothing to cut


# ----------------------------------------------------------------------
# the program's spans (utils.instrumentation.span) in a torch.profiler trace
# ----------------------------------------------------------------------

# the Chrome trace rounds times to nanoseconds; containment allows that
SPAN_EPS_US = 0.01
SPAN_SOLVE = dict(method=CP, nb_iter=400, nb_iter_plot=50, restart="average",
                  restart_period=25, stop_tol=1e-6, permute="align", **CPU)
PRESOLVE = ["presolve.reduce", "presolve.layout", "presolve.lower"]


def _traced_spans(run, log_dir):
    """``run()`` under ``profile_trace``: its result and the trace's
    ``pslp.*`` spans, ``(start, end, name without the prefix)``, ordered
    by start, an outer span before the spans it holds."""
    with profile_trace(log_dir) as d:
        out = run()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len("pslp."):])
             for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("pslp.")]
    return out, sorted(spans, key=lambda s: (s[0], -s[1]))


def _span_tree(spans):
    """Each span's parent (an index into ``spans``, None for a root): the
    innermost span that holds it; spans nest or follow one another."""
    parent, open_ = [], []
    for a, b, _ in spans:
        while open_ and spans[open_[-1]][1] < b - SPAN_EPS_US:
            assert spans[open_[-1]][1] <= a + SPAN_EPS_US, "spans overlap"
            open_.pop()
        parent.append(open_[-1] if open_ else None)
        open_.append(len(parent) - 1)
    return parent


def _solve_case(light):
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp = build_linear_program(8, 0.5, 500, seed=1)[0]

    def run():
        x, _ = lp.solve(light_metrics=light, **SPAN_SOLVE)
        return x, {k: list(getattr(lp, k)) for k in (
            "itrn_curve", "pobj_curve", "dobj_curve",
            "max_violated_equality", "max_violated_inequality",
            "max_violated_constraint")}

    def expected(curves):
        k = len(curves["itrn_curve"])
        assert k >= 2
        # a checkpoint reads energy1 (and in full metrics x, energy2 and
        # both violations) for the callback, then the stop test's four;
        # after the loop: the final x, the back map (no read) and, in
        # light metrics, three device curves a checkpoint
        per_checkpoint = 1 + 4 if light else 5 + 4
        post = [("postsolve", 1), ("postsolve", 0)]
        if light:
            post.append(("postsolve", 3 * k))
        return "solve", ([(s, 0) for s in PRESOLVE]
                         + [("cp.chunk", 0),
                            ("cp.checkpoint", per_checkpoint)] * k + post)

    return run, expected


def _batch_case():
    from pysparselp_tpu_torch import solve_cp_batch
    from pysparselp_tpu_torch.batch import CURVES
    from pysparselp_tpu_torch.examples.potts import build_linear_program

    lp = build_linear_program(6, 0.5, 500, seed=1)[0]
    costs = np.tile(lp.costsvector, (3, 1))
    costs[1] *= 0.5

    def run():
        x, info = solve_cp_batch(lp, costs=costs, nb_iter=60,
                                 nb_iter_plot=20, device="cpu")
        return x, {k: info[k].tolist() for k in CURVES + ("itrn",)}

    def expected(curves):
        # one stacked copy a checkpoint, the final x
        return "batch", ([("batch.lower", 0)]
                         + [("batch.chunk", 0), ("batch.checkpoint", 1)]
                         * len(curves["itrn"]) + [("postsolve", 1)])

    return run, expected


@pytest.mark.parametrize("case", ["solve_light", "solve_full", "batch"])
def test_spans_nest_in_stage_order(tmp_path, case):
    """Under a profiler a solve emits its root span holding, in order,
    its stages (the three presolve stages, a chunk and a checkpoint span a
    checkpoint, postsolve); every ``pslp.sync`` lies inside one stage, as
    many a stage as the code reads the device there; and the solution and
    curves are bit-identical to an untraced run's."""
    run, expected = (_batch_case() if case == "batch"
                     else _solve_case(case == "solve_light"))
    x_plain, curves_plain = run()
    (x, curves), spans = _traced_spans(run, str(tmp_path / "trace"))
    np.testing.assert_array_equal(x, x_plain)
    assert curves == curves_plain
    root_name, stages = expected(curves)

    parent = _span_tree(spans)
    roots = [i for i, p in enumerate(parent) if p is None]
    assert [spans[i][2] for i in roots] == [root_name]
    kids = [i for i, p in enumerate(parent) if p == roots[0]]
    syncs = {i: 0 for i in kids}
    for i, (_, _, name) in enumerate(spans):
        if name == "sync":
            assert parent[i] in syncs, spans[parent[i]]
            syncs[parent[i]] += 1
        else:
            assert parent[i] is None or parent[i] == roots[0], name
    assert [(spans[i][2], syncs[i]) for i in kids] == stages


def test_span_without_profiler_enters_no_record_function(monkeypatch):
    """With no profiler recording, ``span`` is one shared no-op context:
    a solve and a batch never reach ``record_function``."""
    from pysparselp_tpu_torch import solve_cp_batch
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.utils.instrumentation import span

    def refuse(*_a, **_k):
        raise AssertionError("record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("solve") is span("sync")
    lp = build_linear_program(6, 0.5, 500, seed=1)[0]
    lp.solve(light_metrics=True, **SPAN_SOLVE)
    lp.solve(**SPAN_SOLVE)
    solve_cp_batch(lp, costs=lp.costsvector[None], nb_iter=40,
                   nb_iter_plot=20, device="cpu")
