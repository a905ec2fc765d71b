#!/usr/bin/env python3
"""Timing probe of the port's block-ELL SpMV kernel (H-BSR) on one NVIDIA GPU.

    python3 scripts/probe_bsr_spmv.py

On the CLIME system of ``chip_smoke.py`` (p = 150 features: 90,000 x
45,000, 6.84M entries) after the RCM layout presolve, float32: for 32x32,
64x64 and 128x128 tiles, times H-BSR (``ops.bsr_spmv.bsr_spmv``) and its
plain twin in turns (twin, kernel, kernel, twin), the library call
``torch.mv`` on a ``torch.sparse_bsr_tensor`` of the same blocks (one
cuSPARSE bsrmv), and H-CSR on the same matrix, each with CUDA events, for
A x and Aᵀ y; checks the kernel against the twin.  Prints one JSON line per
tile size and direction with the padded entries per nonzero and two bounds
at 3.35 TB/s with the share of each reached: the least bytes of the
product (the matrix's entries with their int32 indices, row pointers, x
and y: H-CSR's bound, the same at every tile size) and the bytes of the
block format's nonzero tiles (with their ids and per-row counts, x and
y); the same lines go to ``chiprun_out/probe_bsr_spmv.json``.  Exits
nonzero without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 SXM at 700 W
TILES = (32, 64, 128)
REPS = 50


def events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_bsr_spmv: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from pysparselp_tpu_torch.ops import bsr_spmv as ops
    from pysparselp_tpu_torch.ops import csr_spmv
    from pysparselp_tpu_torch.problem import (BsrMatrix, CsrMatrix,
                                              apply_rcm_permutation)

    warnings.filterwarnings("ignore", message="Sparse (CSR|BSR) tensor")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sys_ = chip_smoke.folded(chip_smoke.clime_lp(**chip_smoke.CLIME))
    a = apply_rcm_permutation(sys_)[0]["a_ineq"]
    hosts = {"A": a, "At": a.T.tocsr()}
    csr = CsrMatrix.from_scipy(a, torch.float32, dev)
    csr_sides = {"A": csr.csr, "At": csr.csr_t}
    rng = np.random.RandomState(0)
    lines = []
    for tile in TILES:
        op = BsrMatrix.from_scipy(a, torch.float32, dev, tm=tile, tn=tile)
        for side, (tiles, cols, n_in, n_out) in (
                ("A", (op.tiles, op.cols, op.ncols, op.nrows)),
                ("At", (op.tiles_t, op.cols_t, op.nrows, op.ncols))):
            x = torch.as_tensor(rng.randn(n_in), dtype=torch.float32,
                                device=dev)

            def kern(tiles=tiles, cols=cols, x=x, n_in=n_in, n_out=n_out):
                return ops.bsr_spmv(tiles, cols, x, n_in, n_out)

            def plain(tiles=tiles, cols=cols, x=x, n_in=n_in, n_out=n_out):
                return ops.bsr_spmv_reference(tiles, cols, x, n_in, n_out)

            got, want = kern(), plain()
            scale = ops.bsr_spmv_reference(tiles.abs(), cols, x.abs(), n_in,
                                           n_out)
            if not bool(((got - want).abs() <= 1e-5 * scale).all()):
                raise AssertionError(f"H-BSR disagrees with its twin at "
                                     f"{tile}x{tile} tiles ({side})")
            t = [events_ms(torch, f, REPS) for f in (plain, kern, kern, plain)]
            lib, n_pad = chip_smoke.bsr_library(torch, hosts[side],
                                                torch.float32, dev, tile,
                                                tile)
            xpad = torch.nn.functional.pad(x, (0, n_pad - n_in))
            lib_ms = events_ms(torch, lambda lib=lib, xpad=xpad:
                               torch.mv(lib, xpad), REPS)
            csr_ms = events_ms(torch, lambda side=side, x=x: csr_spmv.csr_spmv(
                csr_sides[side], x), REPS)
            nnz = int(hosts[side].nnz)
            moved = nnz * 8 + (n_out + 1) * 4 + n_out * 4 + n_in * 4
            nz_tiles = int((tiles != 0).flatten(2).any(dim=2).sum())
            tile_bytes = 4 * (nz_tiles * (tile * tile + 1) + tiles.shape[0]
                              + n_in + n_out)
            ms = (t[1] + t[2]) / 2
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            tile_bound_ms = tile_bytes / HBM_BYTES_PER_S * 1e3
            rec = dict(tile=tile, side=side, shape=[n_out, n_in],
                       nnz=nnz, tile_rows=tiles.shape[0],
                       k=tiles.shape[1], padded=tiles.numel(),
                       padded_per_nnz=tiles.numel() / nnz,
                       nonzero_tiles=nz_tiles,
                       tile_entries_per_nnz=nz_tiles * tile * tile / nnz,
                       nvidia_smi=smi, ms=ms, plain_ms=(t[0] + t[3]) / 2,
                       library_ms=lib_ms, library_blocks=int(
                           lib.values().shape[0]),
                       csr_ms=csr_ms, bytes=moved, bound_ms=bound_ms,
                       bound_fraction=bound_ms / ms,
                       csr_bound_fraction=bound_ms / csr_ms,
                       tile_bytes=tile_bytes, tile_bound_ms=tile_bound_ms,
                       tile_bound_fraction=tile_bound_ms / ms,
                       achieved_tb_s=moved / (ms * 1e-3) / 1e12,
                       max_abs_err=float((got - want).abs().max()))
            print(json.dumps(rec), flush=True)
            lines.append(rec)
            del lib
        del op
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_bsr_spmv.json").write_text(
        "\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
