# Verbatim copy of pysparselp_tpu/benchmarks.py
"""Multi-solver benchmark driver with convergence-curve comparison.

Equivalent of the reference's random-LP benchmark harness
(``pysparselp/randomLP.py:78-118``): run every (or a chosen subset of)
solver on one problem against a ground-truth solution, collect the standard
curve lists recorded by ``solve``, and optionally render the 3-panel
comparison (distance-to-ground-truth vs iterations / vs time, objective vs
time).  Plotting is gated on matplotlib being importable.
"""

from __future__ import annotations

import numpy as np


DEFAULT_SKIP = ()


def run_solvers(
    lp,
    ground_truth=None,
    ground_truth_indices=None,
    methods=None,
    nb_iter=10000,
    max_time=10.0,
    nb_iter_plot=100,
    skip=DEFAULT_SKIP,
    solve_kwargs=None,
    verbose=True,
) -> dict:
    """Run each solver on ``lp``; returns ``{method: curves-dict}``.

    Each curves-dict carries the curve lists recorded by
    :meth:`~pysparselp_tpu.modeling.SparseLP.solve` plus the final solution,
    cost and max violation — the same data the reference's harness plots and
    its golden-curve tests assert on (``tests/test_netlib.py:62-72``).
    """
    from .modeling import solving_methods

    methods = list(methods if methods is not None else solving_methods)
    solve_kwargs = dict(solve_kwargs or {})
    results = {}
    for method in methods:
        if method in skip:
            continue
        try:
            x, elapsed = lp.solve(
                method=method,
                nb_iter=nb_iter,
                max_time=max_time,
                nb_iter_plot=nb_iter_plot,
                ground_truth=ground_truth,
                ground_truth_indices=ground_truth_indices,
                **solve_kwargs,
            )
        except Exception as e:  # a solver failing must not kill the sweep
            if verbose:
                print(f"[benchmark] {method} failed: {e!r}")
            results[method] = {"error": repr(e)}
            continue
        results[method] = {
            "x": np.asarray(x),
            "elapsed": float(elapsed),
            "cost": float(lp.cost(x)),
            "max_violation": float(lp.max_constraint_violation(x)),
            "itrn_curve": list(lp.itrn_curve),
            "opttime_curve": list(lp.opttime_curve),
            "pobj_curve": list(lp.pobj_curve),
            "dobj_curve": list(lp.dobj_curve),
            "distance_to_ground_truth": list(lp.distance_to_ground_truth),
            "max_violated_constraint": list(lp.max_violated_constraint),
        }
        if verbose:
            r = results[method]
            print(
                f"[benchmark] {method}: cost={r['cost']:.6g} "
                f"viol={r['max_violation']:.2e} t={r['elapsed']:.2f}s "
                f"({len(r['itrn_curve'])} curve points)"
            )
    return results


def plot_results(results, show=True, save_path=None):
    """3-panel comparison plot (mirrors ``randomLP.py:96-117``); returns fig.

    Panels: distance-to-ground-truth vs iteration, vs wall-clock, and
    primal objective vs wall-clock.  No-op (returns None) without matplotlib.
    """
    try:
        import matplotlib
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib always in CI image
        return None

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for method, r in sorted(results.items()):
        if "error" in r:
            continue
        if r["distance_to_ground_truth"]:
            axes[0].semilogy(r["itrn_curve"], r["distance_to_ground_truth"],
                             label=method)
            axes[1].semilogy(r["opttime_curve"],
                             r["distance_to_ground_truth"], label=method)
        axes[2].plot(r["opttime_curve"], r["pobj_curve"], label=method)
    axes[0].set_xlabel("iteration")
    axes[0].set_ylabel("mean |x - x*|")
    axes[1].set_xlabel("time (s)")
    axes[2].set_xlabel("time (s)")
    axes[2].set_ylabel("primal objective")
    for ax in axes:
        ax.legend(fontsize=7)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig


def benchmark_random_lp(nbvar=60, n_eq=5, n_ineq=60, sparsity=0.2, seed=1,
                        **kwargs):
    """End-to-end harness: random feasible LP, scipy ground truth, sweep.

    Mirrors the reference's ``randomLP.py.__main__`` driver: the ground
    truth is the scipy/HiGHS solution, then every solver races against it.
    """
    from .utils.random_lp import generate_random_lp

    lp, _ = generate_random_lp(nbvar=nbvar, n_eq=n_eq, n_ineq=n_ineq,
                               sparsity=sparsity, seed=seed)
    gt, _ = lp.solve(method="scipy_simplex")
    return run_solvers(lp, ground_truth=gt, **kwargs), lp


if __name__ == "__main__":  # pragma: no cover - manual driver
    results, _lp = benchmark_random_lp(max_time=5.0)
    plot_results(results, show=False, save_path="benchmark_random_lp.png")
