#!/usr/bin/env python3
"""Where H-DCA's time goes and whether it depends on its surroundings, on
one NVIDIA GPU: the sequential sweep over Potts-300's one-sided rows
(358,800 rows of <= 3 entries in 602 levels, c̄ in global memory),
float32, its key chain, draws (with the rows staged in level order) and
levels timed apart, from two states,
with the L2 warm or flushed, and inside the DCA solve.

    python3 scripts/probe_dca_sweep.py [--reps 3] [--rows 0]

* ``state``: the solve's start (y = 0, c̄ = c, every row active) against
  ``chip_smoke.dca_state``'s seeded mid-solve state;
* ``l2``: each call warm (the previous call's data in the 50 MB L2) or
  cold (a 256 MB buffer written between calls);
* ``solve``: the DCA solve's own sweeps (``lp.solve(method=
  "dual_coordinate_ascent")``, 2 sweeps) under the profiler.

Device milliseconds per sweep, split over the three kernels
(``chip_smoke.dca_sweep_split``), nanoseconds per link of the key chain
and cycles per link at the SM clock ``nvidia-smi`` reads right after each
case, microseconds per level, and the level schedule's host seconds.

* ``host_chain``: the same key chain (m threefry-2x32 links, each row's
  key stored) run on the card's host CPU, one thread, compiled with g++
  into ``build/``; its nanoseconds per link, and whether its final key is
  the kernel's.

One JSON line per case (the card's name and power limit first), also
written to ``probe_dca_sweep.json`` in the repository's output directory
(``dest`` below); exits nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the key chain of csrc/dca_sweep.cu (dca_chain_kernel) for the host
HOST_CHAIN = r"""
#include <cstdint>
static inline uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}
extern "C" void chain(uint32_t k1, uint32_t k2, long long m, uint32_t* keys,
                      uint32_t* key_out) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  for (long long i = 0; i < m; ++i) {
    keys[2 * i] = k1;
    keys[2 * i + 1] = k2;
    const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
    uint32_t x0 = ks[0], x1 = ks[1];
    for (int r = 0; r < 5; ++r) {
      for (int j = 0; j < 4; ++j) {
        x0 += x1;
        x1 = rotl(x1, rot[r % 2][j]) ^ x0;
      }
      x0 += ks[(r + 1) % 3];
      x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
    }
    k1 = x0;
    k2 = x1;
  }
  key_out[0] = k1;
  key_out[1] = k2;
}
"""


def host_chain(np, key, m, reps=3):
    """The key chain on the host: (seconds per run, final key)."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tag = hashlib.sha256(HOST_CHAIN.encode()).hexdigest()[:12]
    src, lib = build / f"host_chain_{tag}.cpp", build / f"host_chain_{tag}.so"
    if not lib.exists():
        src.write_text(HOST_CHAIN)
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).chain
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    keys = np.empty(2 * m, np.uint32)
    out = np.empty(2, np.uint32)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(key[0], key[1], m, keys.ctypes.data, out.ctypes.data)
        best = min(best, time.perf_counter() - t0)
    return best, (int(out[0]), int(out[1]))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_dca_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from pysparselp_tpu_torch.examples.potts import build_linear_program
    from pysparselp_tpu_torch.ops import dca_sweep as dca
    from pysparselp_tpu_torch.utils.jax_prng import prng_key

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=0,
                    help="the first ROWS rows only (0: all)")
    args = ap.parse_args()

    out = []

    def emit(**rec):
        print(json.dumps(rec), flush=True)
        out.append(rec)

    emit(card=smi("name,power.limit"))
    lp = build_linear_program(300, 0.5, 500)[0]
    lp.convert_to_one_sided_inequality_system()
    a = lp.a_inequalities.tocsr()
    system = (a, np.asarray(lp.b_upper), lp.costsvector, lp.lower_bounds,
              lp.upper_bounds)
    rows = args.rows or None
    m = rows or a.shape[0]
    mid = chip_smoke.dca_state(torch, system, torch.float32, rows=rows)
    ell, b, _active, _y, _cb, lb, ub = mid
    start = (ell, b, torch.ones(m, dtype=torch.bool, device="cuda"),
             torch.zeros(m, device="cuda"),
             torch.as_tensor(lp.costsvector, dtype=torch.float32,
                             device="cuda"), lb, ub)
    flush = torch.empty(64 * 2**20, device="cuda")
    key = prng_key(1)
    levels = ell.schedule.levels

    def split_rec(split, m=m):
        mhz = float(smi("clocks.sm").split()[0])
        return dict(device_ms_per_sweep=split["total"],
                    device_ms_split=split,
                    device_us_per_row=split["total"] / m * 1e3,
                    chain_ns_per_link=split["chain"] / m * 1e6,
                    chain_cycles_per_link=split["chain"] / m * mhz * 1e3,
                    levels_us_per_level=split["levels"] / levels * 1e3,
                    sm_clock_mhz=mhz)

    emit(case="schedule", rows=m, levels=levels,
         schedule_s=ell.schedule.seconds)
    for state, sargs in (("solve_start", start), ("mid_solve", mid)):
        for l2 in ("warm", "cold"):
            def call(sargs=sargs, l2=l2):
                if l2 == "cold":
                    flush.fill_(1.0)
                dca.dca_sweep(*sargs, key, True)

            split = chip_smoke.dca_sweep_split(torch, call, reps=args.reps)
            emit(case="kernel", state=state, l2=l2, rows=m,
                 **split_rec(split))
    lp, gt, idx, _ = build_linear_program(300, 0.5, 500)
    run = dict(method="dual_coordinate_ascent", nb_iter=2, nb_iter_plot=1,
               dtype=np.float32, device="cuda")
    split = chip_smoke.dca_sweep_split(torch, lambda: lp.solve(**run),
                                       reps=1)
    emit(case="solve", rows=a.shape[0], **split_rec(split, a.shape[0]))
    seconds, host_key = host_chain(np, key, m)
    _y, _cb, kernel_key = dca.dca_sweep(*mid, key, True)
    emit(case="host_chain", rows=m, seconds=seconds,
         ns_per_link=seconds / m * 1e9, same_key=host_key == kernel_key)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "probe_dca_sweep.json").write_text(
        "".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
