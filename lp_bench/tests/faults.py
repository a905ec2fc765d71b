#!/usr/bin/env python3
"""Faults planted underneath the timed path, each a way a change to the
port could go wrong while a run still reports numbers.  Each ``plant``
function takes ``patch(obj, name, value)`` (pytest's ``monkeypatch.
setattr``, or plain ``setattr`` in a process of its own).

* ``frozen_step``: every CP step returns the state it was given;
* ``skipped_steps``: after a solve's or a batched call's first chunk,
  each chunk runs a tenth fewer iterations than it reports (a rate that
  reads high);
* ``half_batch``: the second half of a batch is left out: its columns keep
  their state and report the metrics of it;
* ``altered_answer``: the first variable of every returned solution is
  moved by 0.5;
* ``loose_stop``: a solve to tolerance stops at ten times its
  ``stop_tol``.

Run on the card, a fault (or, without ``--fault``, the port as it is)
reads its numbers at a cell's own size, a run of each seed in one process:

    python3 lp_bench/tests/faults.py --workload potts300.steady \\
        --fault skipped_steps --seeds 1 2 3 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

import pysparselp_tpu_torch.batch as port_batch  # noqa: E402
import pysparselp_tpu_torch.solvers.chambolle_pock as port_cp  # noqa: E402

SKIP_SHARE = 0.1


def frozen_step(patch):
    def fused(use_fused, prob, pre, state, nsteps, theta_f, with_sums):
        x, _x3, ye, yi = state
        new = (x, x, ye, yi)
        return (new, (x * nsteps, ye * nsteps, yi * nsteps)) if with_sums \
            else new

    patch(port_cp, "_fused_chunk", fused)
    patch(port_cp, "_cp_iteration", lambda prob, pre, s: s)
    orig = port_batch._batched_chunk
    patch(port_batch, "_batched_chunk",
          lambda prob, pre, state, nsteps: orig(prob, pre, state, 0))


def _fewer(state, nsteps):
    """A chunk's iterations under the fault: all of them from a zero start
    (a solve's first chunk), a tenth fewer after it."""
    if not torch.any(state[0] != 0):
        return nsteps
    return nsteps - int(round(SKIP_SHARE * nsteps))


def skipped_steps(patch):
    fused, impl = port_cp._fused_chunk, port_cp.cp_chunk_impl
    chunk = port_batch._batched_chunk
    patch(port_cp, "_fused_chunk",
          lambda use_fused, prob, pre, state, nsteps, *a: fused(
              use_fused, prob, pre, state, _fewer(state, nsteps), *a))
    patch(port_cp, "cp_chunk_impl",
          lambda prob, pre, state, nsteps: impl(
              prob, pre, state, _fewer(state, nsteps) if nsteps else 0))
    patch(port_batch, "_batched_chunk",
          lambda prob, pre, state, nsteps: chunk(
              prob, pre, state, _fewer(state, nsteps)))


def half_batch(patch):
    orig = port_batch._batched_chunk

    def chunk(prob, pre, state, nsteps):
        new, met = orig(prob, pre, state, nsteps)
        _, stale = orig(prob, pre, state, 0)
        h = state[0].shape[1] // 2
        kept = tuple(s.clone() for s in new)
        for k, s in zip(kept, state):
            k[:, h:] = s[:, h:]
        for key in met:
            met[key][h:] = stale[key][h:]
        return kept, met

    patch(port_batch, "_batched_chunk", chunk)


def altered_answer(patch):
    orig_solve = port_cp.chambolle_pock_ppd

    def solve(*a, **kw):
        x, best = orig_solve(*a, **kw)
        x = x.copy()
        x[0] += 0.5
        return x, best

    orig_batch = port_batch.solve_cp_batch

    def batch(*a, **kw):
        x, info = orig_batch(*a, **kw)
        x = x.copy()
        x[:, 0] += 0.5
        return x, info

    patch(port_cp, "chambolle_pock_ppd", solve)
    patch(port_batch, "solve_cp_batch", batch)


def loose_stop(patch):
    orig = port_cp.chambolle_pock_ppd

    def solve(*a, stop_tol=None, **kw):
        return orig(*a, stop_tol=None if stop_tol is None else 10 * stop_tol,
                    **kw)

    patch(port_cp, "chambolle_pock_ppd", solve)


FAULTS = {"frozen_step": frozen_step, "skipped_steps": skipped_steps,
          "half_batch": half_batch, "altered_answer": altered_answer,
          "loose_stop": loose_stop}
# the faults each kind of traffic can have
KIND_FAULTS = {
    "single_solve": ("frozen_step", "skipped_steps", "altered_answer"),
    "batch": ("frozen_step", "skipped_steps", "half_batch",
              "altered_answer"),
    "closed_loop": ("frozen_step", "altered_answer", "loose_stop"),
}


def main(argv=None):
    from lp_bench.lib import harness, spec
    from lp_bench.lib.systems import PortSystem

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.fault:
        FAULTS[args.fault](setattr)
    for seed in args.seeds:
        cell = spec.load_cell(args.workload)
        t0 = time.perf_counter()
        res = harness.measure(cell, seed, args.seconds, False,
                              PortSystem(args.device, cell.config["dtype"]),
                              args.device, t0)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "seconds": time.perf_counter() - t0,
                          "checks": res["checks"]}), flush=True)


if __name__ == "__main__":
    main()
