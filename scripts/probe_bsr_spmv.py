#!/usr/bin/env python3
"""Tile-size probe of the port's block-sparse SpMV kernel (H-BSR) on one
NVIDIA GPU.

    python3 scripts/probe_bsr_spmv.py [--tiles 8 16 32] [--reps 200]

On the CLIME system of ``chip_smoke.py`` (p = 150 features: 90,000 x
45,000, 6.84M entries) after the RCM layout presolve, float32, for each
tile size T: the tile set's size (nonzero tiles, fill, tiles per tile-row
and per tile-column), then H-BSR's SpMV pair as the solve calls it, A x
then Aᵀ y in turns (``chip_smoke.pair_times``: events per pair, the
profiler's device time of each direction, host time per pair), in two
layouts:

* ``one_set``: one tile set serves both directions (the shipped layout;
  Aᵀ y through the tile-column index);
* ``two_sets``: a second tile set built from Aᵀ, both directions by the
  row kernel (the tiles stored twice);

beside cuSPARSE bsrmv (``torch.mv`` of a ``torch.sparse_bsr_tensor``, one
for A and one for Aᵀ) on the same T x T blocks, and, once, cuSPARSE on
128 x 128 blocks and H-CSR on the same matrix.  Every kernel is checked
against its twin per row within 1e-5 (|A||x|)_row.  H-BSR's pairs are
also timed cold, each product with the L2 flushed before it
(``chip_smoke.cold_times``), and held against the bytes of the tile set
(``bsr_tile_bytes``) at 3.35 TB/s; warm, one tile set is read from L2
and its pair is held against the same bytes over the L2 read rate of a
reduction over a buffer of the tile set's size
(``chip_smoke.read_rates``).  Beside them, H-CSR's bytes
(``least_spmv_bytes``, the same at every T).  Prints
one JSON line per measurement with the card's name and power limit; the
same lines go to ``chiprun_out/probe_bsr_spmv.json``.  The parent
commit's kernel is timed by ``scripts/compare_kernels.py --repo``.  Exits
nonzero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiles", type=int, nargs="+", default=[8, 16, 32])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_bsr_spmv: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as smoke
    from pysparselp_tpu_torch.ops import bsr_spmv as ops
    from pysparselp_tpu_torch.problem import CsrMatrix, apply_rcm_permutation

    warnings.filterwarnings("ignore", message="Sparse (CSR|BSR) tensor")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    dev, dt, s = torch.device("cuda"), torch.float32, 4
    sys_ = smoke.folded(smoke.clime_lp(**smoke.CLIME))
    a = apply_rcm_permutation(sys_)[0]["a_ineq"]
    at = a.T.tocsr()
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(a.shape[1]), dtype=dt, device=dev)
    y = torch.as_tensor(rng.randn(a.shape[0]), dtype=dt, device=dev)
    least = smoke.least_spmv_bytes(a, s) + smoke.least_spmv_bytes(at, s)
    flush = torch.zeros(smoke.L2_FLUSH_BYTES // 4, device=dev)
    lines = []

    def emit(**rec):
        rec = dict(nvidia_smi=smi, **rec)
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    def check(what, op, v, transpose, got):
        want = ops.bsr_spmv_reference(op, v, transpose)
        scale = ops.bsr_spmv_reference(op.abs(), v.abs(), transpose)
        if not bool(((got - want).abs() <= 1e-5 * scale).all()):
            raise AssertionError(f"H-BSR disagrees with its twin: {what}")

    def library(tile):
        libs = [smoke.bsr_library(torch, h, dt, dev, tile) for h in (a, at)]
        (la, na), (lb, nb) = libs
        xa = torch.nn.functional.pad(x, (0, na - x.numel()))
        yb = torch.nn.functional.pad(y, (0, nb - y.numel()))
        return smoke.pair_times(torch, lambda: torch.mv(la, xa),
                                lambda: torch.mv(lb, yb), args.reps)

    for tile in args.tiles:
        one = ops.BsrOperand.from_scipy(a, dt, dev, tile)
        two = ops.BsrOperand.from_scipy(at, dt, dev, tile)
        for what, op, v, transpose in (("one_set A", one, x, False),
                                       ("one_set At", one, y, True),
                                       ("two_sets At", two, y, False)):
            check(f"{tile} {what}", op, v, transpose,
                  ops.bsr_spmv(op, v, transpose))
        t_rows, t_cols = one.row_ptr.numel() - 1, one.col_ptr.numel() - 1
        tile_bytes = (smoke.bsr_tile_bytes(one, False, s)
                      + smoke.bsr_tile_bytes(one, True, s))
        geometry = dict(
            tile=tile, nnz=int(a.nnz), n_tiles=one.n_tiles,
            stored_entries=one.stored_entries,
            fill=a.nnz / one.stored_entries, tile_rows=t_rows,
            tile_cols=t_cols,
            max_tiles_per_row=int(one.row_ptr.diff().max()),
            max_tiles_per_col=int(one.col_ptr.diff().max()),
            tile_set_mb=one.stored_entries * s / 1e6,
            csr_pair_bound_us=least / smoke.HBM_BYTES_PER_S * 1e6,
            pair_tile_bound_us=tile_bytes / smoke.HBM_BYTES_PER_S * 1e6)
        rates = smoke.read_rates(torch, one.stored_entries * s, flush)
        emit(kind="geometry", **geometry, read_rates=rates)
        for layout, fa, fb in (
                ("one_set", lambda: ops.bsr_spmv(one, x),
                 lambda: ops.bsr_spmv(one, y, True)),
                ("two_sets", lambda: ops.bsr_spmv(one, x),
                 lambda: ops.bsr_spmv(two, y))):
            t = smoke.pair_times(torch, fa, fb, args.reps)
            cold = [smoke.cold_times(torch, f, t["kernel_names"], flush)
                    for f in (fa, fb)]
            cold_us = sum(c["device_us"] for c in cold)
            if layout == "one_set":
                # one tile set, held in L2 between the two products
                t["warm_l2_bound_fraction"] = (tile_bytes / rates["l2"]
                                               * 1e6 / t["device_us"])
            emit(kind="pair", tile=tile, layout=layout, **t,
                 cold_a_us=cold[0]["device_us"],
                 cold_b_us=cold[1]["device_us"], cold_us=cold_us,
                 tile_bound_fraction=geometry["pair_tile_bound_us"]
                 / cold_us)
        emit(kind="pair", tile=tile, layout="cusparse_bsrmv",
             **library(tile))
        del one, two
    emit(kind="pair", tile=128, layout="cusparse_bsrmv", **library(128))
    csr = CsrMatrix.from_scipy(a, dt, dev)
    emit(kind="pair", tile=None, layout="h_csr",
         **smoke.pair_times(torch, lambda: csr.matvec(x),
                            lambda: csr.rmatvec(y), args.reps))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_bsr_spmv.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
