"""The comparison that decides ``correct``: what the window produced,
judged by the plain reference (``reference/potts.py``), each number against
the cell's limit (``limits/<cell>.json``).

* the curves (``single_solve``, ``batch``): the program's primal energy,
  dual bound and worst residual at its first ``check_checkpoints``
  checkpoints (a key of the traffic mix) against the reference's own
  Chambolle-Pock run from zero in float64 over the same iterations on the
  reference's own LP of the same images; relative gaps
  ``|p - r| / (1 + |r|)``, the worst over frames.  ``start_*`` is the
  first checkpoint, which closes set-up and opens the window;
  ``window_*`` the worst of the later ones, inside the window, so that
  iterations counted but not run there read as a gap;
* the answer: the returned solution against the exact optimum E* of its
  image (an integer minimum cut; the LP is tight): the worst of the
  relative gaps ``|E - E*| / (1 + |E*|)`` of its cost and of the Potts
  energy of its pixel labels, of its worst row residual (where the answer
  has every variable) and of its excess over the bounds;
* a solve to tolerance (``closed_loop``): the guarantee the configuration
  states for a solve that ``stop_tol`` stopped (one that ended before its
  iteration cap): the worst residual and relative primal-dual gap of the
  program's last checkpoint (``stop_viol``, ``stop_gap``, by the
  program's own metrics), and the worst row residual of the returned
  solution worked out again by the reference in float64 (``resid``, with
  every solve's bound excess); every solve's cost and pixel energy against
  E* (``energy_gap``).

Each function returns ``(numbers, attempted, failed)``; ``numbers`` maps a
name to its value.  The references run after the window, on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import potts as ref
from . import inputs


def _rel(p, r):
    return np.abs(np.asarray(p, np.float64) - r) / (1.0 + np.abs(r))


def _lp(cell, unary):
    cfg = cell.config
    return ref.PottsLP(unary.shape[-2], unary.shape[-1], cfg["coef_potts"],
                       float(cfg["coef_mul"]))


def _curves(plp, unary, curves, plot, count, last, device):
    """Gaps of the program's first ``count`` checkpoints over the frames of
    ``unary`` ``(B, H, W)``; the program's curves are ``(P, B)`` arrays.
    Returns ``(start_energy, start_viol, window_energy, window_viol)``,
    each ``(B,)``."""
    if count < 2 or count - 1 > last:
        raise ValueError(f"check_checkpoints={count} does not reach into "
                         f"the window (its last checkpoint is {last})")
    want = plot * np.arange(1, count + 1)
    if not np.array_equal(np.asarray(curves["itrn"][:count]), want):
        raise ValueError(f"the checkpoints are not every nb_iter_plot={plot}")
    _, rc = ref.cp_run(plp, unary, count * plot, dtype=torch.float64,
                       device=device, chunk=plot)
    energy = np.maximum(_rel(curves["energy1"][:count], rc["energy1"]),
                        _rel(curves["energy2"][:count], rc["energy2"]))
    viol = _rel(curves["viol"][:count], rc["viol"])
    return energy[0], viol[0], energy[1:].max(0), viol[1:].max(0)


def energy_gap(plp, x, unary, e_star):
    """The worst of the relative gaps to the optimum ``e_star`` of the
    pixels' Potts energy and, where ``x`` has every variable, of its
    cost."""
    scale = 1.0 + abs(e_star)
    parts = [abs(ref.pixel_energy(plp, x[:plp.n_pix], unary) - e_star) / scale]
    if x.size == plp.n:
        cost, _ = plp.evaluate(x, unary)
        parts.append(abs(float(cost[0]) - e_star) / scale)
    return max(parts)


def violation(plp, x):
    """The worst row residual (where ``x`` has every variable) and bound
    excess of one answer, in float64."""
    parts = [ref.bound_excess(plp, x)]
    if x.size == plp.n:
        parts.append(ref.max_residual(plp, x))
    return max(parts)


def answer_gap(plp, x, unary, e_star):
    """How far one answer is from the optimum ``e_star``, in cost or in
    feasibility."""
    return max(energy_gap(plp, x, unary, e_star), violation(plp, x))


def _curve_numbers(run, plp, unary, curves, device):
    count = int(run.traffic["check_checkpoints"])
    e0, v0, ew, vw = _curves(plp, unary, curves, run.plot, count, run.last,
                             device)
    return {"start_energy": e0, "start_viol": v0, "window_energy": ew,
            "window_viol": vw}


def single_solve(run, limits, device):
    plp = _lp(run.cell, run.unary)
    c = run.curves
    per = _curve_numbers(run, plp, run.unary[None], {
        "itrn": c["itrn"], **{k: np.asarray(c[k])[:, None]
                              for k in ("energy1", "energy2", "viol")}},
        device)
    e_star, _ = ref.graph_cut_energy(plp, run.unary)
    nums = {k: float(v.max()) for k, v in per.items()}
    nums["final_gap"] = answer_gap(plp, run.x, run.unary, e_star)
    failed = int(any(nums[k] > limits[k] for k in nums))
    return nums, 1, failed


def closed_loop(run, limits, device):
    plp = _lp(run.cell, run.unary[0])
    cap = int(run.traffic["solve_kwargs"]["nb_iter"])
    e_star = {}
    rows = []
    for s in run.solves:
        f, c = s["frame"], s["curves"]
        if f not in e_star:
            e_star[f] = ref.graph_cut_energy(plp, run.unary[f])[0]
        row = {"energy_gap": energy_gap(plp, s["x"], run.unary[f], e_star[f]),
               "resid": ref.bound_excess(plp, s["x"])}
        if int(c["itrn"][-1]) < cap:
            e1, e2 = float(c["energy1"][-1]), float(c["energy2"][-1])
            row.update(stop_viol=float(c["viol"][-1]),
                       stop_gap=abs(e1 - e2) / (1.0 + abs(e1) + abs(e2)),
                       resid=violation(plp, s["x"]))
        rows.append(row)
    names = ("stop_viol", "stop_gap", "resid", "energy_gap")
    nums = {k: max([r[k] for r in rows if k in r], default=0.0)
            for k in names}
    failed = sum(any(v > limits[k] for k, v in r.items()) for r in rows)
    return nums, len(rows), int(failed)


def batch(run, limits, device):
    plp = _lp(run.cell, run.unary[0])
    per = _curve_numbers(run, plp, run.unary, run.curves, device)
    bsz = run.unary.shape[0]
    k = min(int(run.traffic["check_frames"]), bsz)
    sample = inputs.rng(run.seed, "check").choice(bsz, size=k, replace=False)
    gaps = np.array([ref.bound_excess(plp, m.ravel()) for m in run.maps])
    for f in sample:
        e_star, _ = ref.graph_cut_energy(plp, run.unary[f])
        gaps[f] = answer_gap(plp, run.maps[f].ravel(), run.unary[f], e_star)
    per["final_gap"] = gaps
    nums = {k: float(v.max()) for k, v in per.items()}
    bad = np.zeros(bsz, bool)
    for k, v in per.items():
        bad |= v > limits[k]
    return nums, bsz, int(bad.sum())


KINDS = {"single_solve": single_solve, "closed_loop": closed_loop,
         "batch": batch}


def check(run, limits, device):
    return KINDS[run.traffic["kind"]](run, limits, device)
