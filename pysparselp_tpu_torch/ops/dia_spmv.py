"""H-DIA: the DIA sparse matrix-vector product, ``y[r] = Σ_d vals[d, r] ·
x[r + offs[d]]`` (kernel source: ``csrc/dia_spmv.cu``).

Replaces ``pysparselp_tpu/ops/dia_pallas.py::_dia_matvec_pallas`` (K4) and
computes ``_dia_matvec_pallas_dyn``'s function (K5): the offsets are an
int32 device tensor.  :func:`dia_apply` (on a :class:`DiaOperand`, checked once) and
:func:`dia_spmv` launch the kernel for CUDA tensors and run
:func:`dia_spmv_reference`, its plain PyTorch twin, for CPU tensors; they
never fall back from one to the other.

H-DIA-B, the batched product ``Y[r, b] = Σ_d vals[d, r] · X[r + offs[d],
b]`` over ``X`` of shape ``(n_in, B)`` (batch-last, contiguous), is the
same module's second kernel entry: :func:`dia_spmm` (on the same
:class:`DiaOperand`) launches it for CUDA tensors and runs
:func:`dia_spmm_reference` for CPU tensors.  Column ``b`` of its result
equals :func:`dia_apply` of ``X[:, b]`` bit for bit on both sides.  The
kernel stages a tile of rows' window of X and plane values in shared
memory on a plan (:func:`dia_spmm_plan`) built once per operator and batch
size (:meth:`DiaOperand.batch_launch`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _I, _P, _I, _P, _I, _P)
# the batched entry: plan (a _PlanStruct), X, n_in, Y, stream
_ARGTYPES_B = (_P, _P, _I, _P, _P)
# offsets passed by value in the kernel's parameters (kParamDiags in
# csrc/dia_spmv.cu): the batch path's DIA_AUTO_MAX_OFFSETS; more are read
# from the device
PARAM_DIAGS = 32
# one pipeline stage (a tile's planes and X window) of the two a CTA holds;
# a wider batch row takes column tiles, and STAGE_MAX only where no
# tile fits STAGE_BYTES (two stages within the H100's 227 KB)
STAGE_BYTES = 32 * 1024
STAGE_MAX = 112 * 1024
SMEM_LIMIT = 232448
# rows per tile tried, largest first; full rows of the batch need MIN_ROWS
ROWS = (1024, 512, 256, 128, 64, 32, 16, 8, 4)
MIN_ROWS = 32
# tiles of more than DIRECT_ROWS rows only where they leave MIN_TILES tiles
# (about four CTAs an SM of the H100's 132), and DIRECT_ROWS rows a tile
# read direct (measured on the batch path's operators, PERF.md)
DIRECT_ROWS = 256
MIN_TILES = 528


def _up(v, k):
    return -(-v // k) * k


@dataclasses.dataclass(frozen=True)
class DiaBatchPlan:
    """How H-DIA-B tiles one operator at one batch size.  A tile is
    ``rows`` output rows by ``cols`` columns of the batch (``cols == nb``
    unless a row of X is too wide for shared memory).  It stages its
    ``(ndiag, rows)`` plane values and the X rows it reads, clipped to
    ``[0, n_in)`` and zero outside: one span ``[r0 + off_min, r0 + rows +
    off_max)`` (``union``) or one range of ``rows`` rows per diagonal.  A
    thread sums ``cpt`` neighbouring columns of a row (16 bytes when the
    batch row and X are 16-byte aligned, else one).  ``bulk``: the copies
    are ``cp.async.bulk`` (full, aligned rows), else ``cp.async``.
    ``direct``: nothing is staged, the tile reads the same rows straight
    from global memory (one diagonal: no X value is read twice)."""

    n_out: int
    offsets: tuple
    nb: int
    itemsize: int
    rows: int
    cols: int
    cpt: int
    union: bool
    bulk: bool
    direct: bool = False

    ndiag = property(lambda self: len(self.offsets))
    off_min = property(lambda self: min(self.offsets, default=0))
    span = property(lambda self: max(self.offsets, default=0) - self.off_min)
    row_tiles = property(lambda self: -(-self.n_out // self.rows))
    col_tiles = property(lambda self: -(-self.nb // self.cols))
    n_tiles = property(lambda self: self.row_tiles * self.col_tiles)

    @property
    def window_rows(self):
        """Rows of X one tile stages (its span, or ``ndiag`` ranges)."""
        return _window_rows(self.rows, self.ndiag, self.span, self.union)

    @property
    def window_bytes(self):
        return self.window_rows * self.cols * self.itemsize

    @property
    def stage_bytes(self):
        if self.direct:
            return 0
        return _up(self.ndiag * self.rows * self.itemsize
                   + self.window_bytes, 128)

    @property
    def smem_bytes(self):
        """Two stages, their two mbarriers and the offsets."""
        return 2 * self.stage_bytes + 16 + 4 * self.ndiag

    def ranges(self, tile, n_in):
        """``[(first, stop, at)]``: the X rows ``[first, stop)`` tile
        ``tile`` copies (clipped to ``[0, n_in)``, empty ranges left out)
        and the window row each range lands on; the window's other rows
        are zeros."""
        r0 = tile // self.col_tiles * self.rows
        if self.union:
            spans = [(r0 + self.off_min, self.window_rows, 0)] \
                if self.ndiag else []
        else:
            spans = [(r0 + off, self.rows, d * self.rows)
                     for d, off in enumerate(self.offsets)]
        out = []
        for lo, n, base in spans:
            a, b = min(max(lo, 0), n_in), min(max(lo + n, 0), n_in)
            if b > a:
                out.append((a, b, base + a - lo))
        return out

    def grid(self, max_ctas):
        """CTAs of the persistent grid: at most ``max_ctas``, every one
        the same number of tiles within one."""
        per = -(-self.n_tiles // max(1, max_ctas))
        return max(1, -(-self.n_tiles // per))


def _window_rows(rows, ndiag, span, union):
    if not ndiag:
        return 0
    return rows + span if union else ndiag * rows


def dia_spmm_plan(n_out, offsets, nb, itemsize, aligned=True, rows=None,
                  union=None, cols=None, direct=None) -> DiaBatchPlan:
    """H-DIA-B's plan for an operator of ``n_out`` rows and the host
    ``offsets`` at batch size ``nb`` (``itemsize`` bytes a value; X
    16-byte ``aligned`` or not).  In each mode (one span, or one range per
    diagonal) the tile takes the most rows of ``ROWS`` (at least
    ``MIN_ROWS``, at most ``n_out`` rounded up) whose stage of whole batch
    rows fits ``STAGE_BYTES``; of the two, the mode that copies fewer X
    rows per output row (the span on a tie), at most ``DIRECT_ROWS``
    rows where that leaves fewer than ``MIN_TILES`` tiles.  Where neither
    fits, column tiles: ``MIN_ROWS`` rows (or fewer) by the most columns
    that fit ``STAGE_BYTES``, then ``STAGE_MAX``.  One diagonal is read
    ``direct`` (``DIRECT_ROWS`` rows a tile, whole batch rows).  ``rows``,
    ``union``, ``cols`` and ``direct`` force a choice (tests and
    probes)."""
    offsets = tuple(int(o) for o in offsets)
    ndiag = len(offsets)
    span = max(offsets) - min(offsets) if ndiag else 0
    vec = 16 // itemsize
    cpt = vec if aligned and nb % vec == 0 else 1
    if direct or (direct is None and ndiag == 1 and rows is None
                  and union is None and cols is None):
        return DiaBatchPlan(
            n_out=int(n_out), offsets=offsets, nb=int(nb),
            itemsize=itemsize, rows=rows or DIRECT_ROWS,
            cols=nb if cols is None else cols, cpt=cpt, union=True,
            bulk=False, direct=True)
    if (cols is not None and (cols < 1 or cols % cpt)) or (
            rows is not None and rows * itemsize % 16):
        raise ValueError(f"dia_spmm: {cols} columns or {rows} rows a tile "
                         f"do not take {cpt} columns a thread and whole "
                         "16-byte plane rows")
    tall = next((r for r in reversed(ROWS) if r >= n_out), ROWS[0])
    choices = [r for r in ROWS if r <= tall] if rows is None else [rows]
    modes = (True, False) if union is None else (bool(union),)

    def window(r, u):
        return _window_rows(r, ndiag, span, u)

    def fits(r, u, c, limit):
        stage = (ndiag * r + window(r, u) * c) * itemsize
        return stage <= limit and 2 * _up(stage, 128) + 16 + 4 * ndiag \
            <= SMEM_LIMIT

    # (X rows copied per output row, fewer columns, rows, union, columns)
    options = []
    full = nb if cols is None else cols
    for u in modes:
        r = next((r for r in choices if (r >= MIN_ROWS or rows is not None)
                  and fits(r, u, full, STAGE_BYTES)
                  and (r <= DIRECT_ROWS or rows is not None
                       or -(-n_out // r) >= MIN_TILES)), None)
        if r is not None:
            options.append((window(r, u) / r, 0, r, u, full))
    for limit in (STAGE_BYTES, STAGE_MAX):
        for r in [r for r in choices if r <= MIN_ROWS]:
            if options or cols is not None:
                break
            for u in modes:
                per_col = window(r, u) * itemsize
                room = limit - ndiag * r * itemsize
                c = min(nb, room // per_col // cpt * cpt if per_col else nb)
                if c >= cpt and fits(r, u, c, limit):
                    options.append((window(r, u) / r, -c, r, u, c))
    if not options:
        raise ValueError(
            f"dia_spmm: no tile of {ndiag} diagonals spanning {span} rows "
            f"at batch size {nb} fits {STAGE_MAX} bytes of shared memory")
    _, _, r, u, c = min(options, key=lambda o: o[:2])
    return DiaBatchPlan(
        n_out=int(n_out), offsets=offsets, nb=int(nb), itemsize=itemsize,
        rows=r, cols=c, cpt=cpt, union=u,
        bulk=bool(aligned and cpt == vec and c == nb))


def pack_planes(vals, plan: DiaBatchPlan):
    """The operator's ``(ndiag, n_out)`` planes tile-major, ``(row_tiles,
    ndiag, rows)``, zero past ``n_out``: a tile's plane values are one
    contiguous copy."""
    pad = plan.row_tiles * plan.rows - plan.n_out
    return F.pad(vals, (0, pad)).reshape(
        plan.ndiag, plan.row_tiles, plan.rows).transpose(0, 1).contiguous()


class _PlanStruct(ctypes.Structure):
    """``DiaBPlan`` of ``csrc/dia_spmv.cu``, field for field."""

    _fields_ = ([("planes", _P), ("offs", _P)]
                + [(name, _I) for name in (
                    "n_out", "nb", "ndiag", "rows", "cols", "cpt",
                    "union_window", "bulk", "row_tiles", "col_tiles",
                    "window_rows", "off_min", "grid", "stage_bytes",
                    "smem_bytes", "direct")]
                + [("offsets", _I * PARAM_DIAGS)])


class BatchLaunch:
    """One plan made ready for the card: the tile-major planes, the grid
    and the kernel's parameter struct (``address`` is what the C entry
    takes)."""

    __slots__ = ("plan", "planes", "struct", "address")

    def __init__(self, plan, planes, offs, grid):
        self.plan, self.planes = plan, planes
        s = self.struct = _PlanStruct()
        s.planes, s.offs = planes.data_ptr(), offs.data_ptr()
        for name in ("n_out", "nb", "ndiag", "rows", "cols", "cpt",
                     "window_rows", "off_min", "stage_bytes", "smem_bytes",
                     "direct"):
            setattr(s, name, int(getattr(plan, name)))
        s.union_window, s.bulk = int(plan.union), int(plan.bulk)
        s.row_tiles, s.col_tiles, s.grid = plan.row_tiles, plan.col_tiles, grid
        for d, off in enumerate(plan.offsets[:PARAM_DIAGS]):
            s.offsets[d] = off
        self.address = ctypes.addressof(s)


def _max_ctas(op, plan):
    """The resident CTAs of H-DIA-B at the plan's shared memory, on every
    SM of the operand's card."""
    blocks = ctypes.c_int(0)
    fn = _build.function(f"pslp_dia_spmm_occupancy_{_build.suffix(op.dtype)}",
                         (_I, _I, ctypes.POINTER(ctypes.c_int)))
    _build.check(fn(plan.cpt, plan.smem_bytes, ctypes.byref(blocks)),
                 "pslp_dia_spmm_occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"dia_spmm: no CTA of {plan.smem_bytes} bytes of "
                           "shared memory fits an SM")
    props = torch.cuda.get_device_properties(op.device_index)
    return blocks.value * props.multi_processor_count


def widen(vals):
    """Planes in the dtype their products run in: bfloat16 planes (which
    serve float32 solves) widened exactly to float32, others as they
    are."""
    return vals.float() if vals.dtype == torch.bfloat16 else vals


def dia_spmv_reference(vals, offs, x, n_out):
    """Plain twin: diagonals in ascending-offset order, reads outside ``x``
    contribute zero; bfloat16 planes widened exactly to float32."""
    offsets = [int(o) for o in offs.tolist()]
    vals = widen(vals)
    y = torch.zeros(n_out, dtype=vals.dtype, device=vals.device)
    if not offsets:
        return y
    n_in = x.shape[0]
    left = max(0, -min(offsets))
    right = max(0, max(offsets) + n_out - n_in)
    xp = F.pad(x, (left, right))
    for d, off in enumerate(offsets):
        y = y + vals[d, :n_out] * xp[left + off:left + off + n_out]
    return y


def dia_spmm_reference(vals, offs, x, n_out):
    """Plain twin of H-DIA-B: :func:`dia_spmv_reference`'s shift loop with
    a trailing batch axis, ``x`` (n_in, B) -> (n_out, B)."""
    offsets = [int(o) for o in offs.tolist()]
    vals = widen(vals)
    y = torch.zeros((n_out, x.shape[1]), dtype=vals.dtype, device=vals.device)
    if not offsets:
        return y
    n_in = x.shape[0]
    left = max(0, -min(offsets))
    right = max(0, max(offsets) + n_out - n_in)
    xp = F.pad(x, (0, 0, left, right))
    for d, off in enumerate(offsets):
        y = y + vals[d, :n_out, None] * xp[left + off:left + off + n_out]
    return y


class DiaOperand:
    """One orientation of a DIA operator on its device, ready to launch:
    ``vals`` (ndiag, n_out), ``offs`` int32 (ndiag,) and the kernel's bound
    C entry.  ``vals`` is float32 or float64, or bfloat16 for a float32
    product (``dtype``, the product's, is then float32: H-DIA widens each
    value exactly as it reads it).  Checked once here; :func:`dia_apply`
    checks only ``x``."""

    __slots__ = ("vals", "offs", "n_out", "device", "dtype", "device_index",
                 "entry", "entry_b", "offsets", "_launches")

    def __init__(self, vals, offs, n_out):
        dev = vals.device
        if offs.dtype != torch.int32 or vals.shape != (offs.shape[0], n_out):
            raise ValueError("dia_spmv: vals must be (ndiag, n_out), offs "
                             "int32")
        if vals.dtype not in (torch.float32, torch.float64, torch.bfloat16):
            raise TypeError(f"kernels take float32, float64 or bfloat16 "
                            f"planes, got {vals.dtype}")
        for t in (vals, offs):
            if t.device != dev:
                raise ValueError(f"tensor on {t.device}, expected {dev}")
            if dev.type == "cuda" and not t.is_contiguous():
                raise ValueError("kernel arguments must be contiguous")
        self.vals, self.offs, self.n_out = vals, offs, int(n_out)
        self.device = dev
        self.dtype = (torch.float32 if vals.dtype == torch.bfloat16
                      else vals.dtype)
        self.device_index = self.entry = self.entry_b = None
        self.offsets, self._launches = None, {}
        if dev.type == "cuda":
            self.device_index = _build.device_index(dev)
            self.entry = _build.Entry(
                f"pslp_dia_spmv_{_build.plane_suffix(self.dtype, vals.dtype)}",
                _ARGTYPES, vals, offs, offs.shape[0])
            self.entry_b = _build.Entry(
                f"pslp_dia_spmm_{_build.suffix(self.dtype)}", _ARGTYPES_B)


    def batch_launch(self, nb, aligned=True, plan=None):
        """H-DIA-B's :class:`BatchLaunch` at batch size ``nb`` (X 16-byte
        ``aligned`` or not) on its :func:`dia_spmm_plan`, or on ``plan``;
        made on the first call with that plan and kept (the offsets are
        read back to the host once)."""
        key = (nb, aligned) if plan is None else plan
        found = self._launches.get(key)
        if found is None:
            if plan is None:
                if self.offsets is None:
                    self.offsets = tuple(int(o) for o in self.offs.tolist())
                plan = dia_spmm_plan(self.n_out, self.offsets, nb,
                                     self.vals.element_size(), aligned)
            found = self._launches[key] = BatchLaunch(
                plan, pack_planes(self.vals, plan), self.offs,
                plan.grid(_max_ctas(self, plan)))
        return found


def dia_apply(op: DiaOperand, x):
    """``y = A x`` for the DIA operand ``op``, ``x`` (n_in,)."""
    if x.device.type == "cpu":
        return dia_spmv_reference(op.vals, op.offs, x, op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype or x.dim() != 1
            or not x.is_contiguous()):
        raise ValueError(f"dia_spmv: x must be a contiguous 1-D {op.dtype} "
                         f"tensor on {op.device}, got {x.dtype} on "
                         f"{x.device}")
    y = torch.empty(op.n_out, dtype=op.dtype, device=op.device)
    op.entry(x.data_ptr(), x.shape[0], y.data_ptr(), op.n_out,
             _build.stream(op.device_index))
    dia_spmv.launches += 1
    return y


def dia_spmm(op: DiaOperand, x, plan=None):
    """``Y = A X`` for the DIA operand ``op``, ``x`` (n_in, B) batch-last
    (H-DIA-B), on the operand's plan for ``B`` and the alignment of ``x``,
    or on ``plan`` (a :func:`dia_spmm_plan` of the operand; tests and
    probes)."""
    if x.device.type == "cpu":
        return dia_spmm_reference(op.vals, op.offs, x, op.n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm runs on CUDA or the CPU, not {x.device}")
    if (x.device != op.device or x.dtype != op.dtype or x.dim() != 2
            or not x.is_contiguous()):
        raise ValueError(f"dia_spmm: x must be a contiguous (n_in, B) "
                         f"{op.dtype} tensor on {op.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if op.vals.dtype != op.dtype:
        raise TypeError("dia_spmm: H-DIA-B reads planes stored in the "
                        f"product's dtype ({op.dtype}), got {op.vals.dtype}")
    nb = x.shape[1]
    aligned = x.data_ptr() % 16 == 0
    if plan is not None and (plan.nb != nb or plan.n_out != op.n_out or (
            not aligned and (plan.bulk or plan.cpt > 1))):
        raise ValueError(f"dia_spmm: the plan takes a 16-byte aligned "
                         f"({plan.n_out}, {plan.nb}) product; x is "
                         f"{tuple(x.shape)}, aligned={aligned}")
    y = torch.empty((op.n_out, nb), dtype=op.dtype, device=op.device)
    if op.n_out and nb:
        launch = op.batch_launch(nb, aligned, plan)
        op.entry_b(launch.address, x.data_ptr(), x.shape[0], y.data_ptr(),
                   _build.stream(op.device_index))
        dia_spmm.launches += 1
    return y


dia_spmm.launches = 0


def dia_spmv(vals, offs, x, n_out):
    """``y = A x`` for a DIA operator: ``vals`` (ndiag, n_out), ``offs``
    int32 (ndiag,), ``x`` (n_in,); every argument checked on each call
    (operators that are applied many times keep a :class:`DiaOperand`)."""
    if x.device.type == "cpu":
        return dia_spmv_reference(vals, offs, x, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on CUDA or the CPU, not {x.device}")
    return dia_apply(DiaOperand(vals, offs, n_out), x)


dia_spmv.launches = 0
