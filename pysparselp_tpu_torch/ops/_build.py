"""Build and load the port's CUDA kernels on first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into ONE shared library with a plain C interface under the repository's
``build/`` directory, cached by a hash of the sources and flags, and loaded
with ``ctypes``.  Pointers and the CUDA stream travel as ``c_void_p``; each
C entry returns ``cudaGetLastError()`` after its launches, and
:func:`check` raises on a nonzero code.  Nothing is built when the package
is imported or when the kernels' plain twins run on the CPU.

``--fmad=false`` keeps every multiply and add separately rounded, so the
DIA kernels round exactly like their PyTorch twins' separate operations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pysparselp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v")

_lib = None
_functions: dict = {}
build_info: dict = {}   # {"seconds", "path", "cached", "log"} after the build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the port's "
                       "kernels are built from source on first use")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libpysparselp_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    cached = so.exists()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        procs = {src.name: subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)}
        for name, proc in procs.items():
            log += f"== {name}\n{proc.communicate()[0]}"
        failed = [name for name, proc in procs.items() if proc.returncode]
        tmp = so.with_name(f"{tag}.tmp.so")
        if not failed:
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log += link.stdout
            if link.returncode != 0:
                failed = ["link"]
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, so)   # atomic: concurrent builders never see a torn file
    lib = ctypes.CDLL(str(so))
    lib.pslp_error_string.argtypes = [ctypes.c_int]
    lib.pslp_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      cached=cached, log=log)
    _lib = lib
    return lib


def function(name: str, argtypes):
    """The C entry ``name`` with its ``argtypes`` declared (int result)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = library().pslp_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class Entry:
    """The launch path every wrapper shares: the C entry ``name`` resolved
    on its first call (the library is built then, never on the CPU), and
    the leading arguments an operator fixes (``head``: tensors as their
    device pointers, ints) converted to ctypes once.  A call passes only
    the per-call arguments and raises on a nonzero CUDA error code.  The
    caller keeps the head's tensors alive."""

    __slots__ = ("name", "argtypes", "head", "_fn")

    def __init__(self, name, argtypes, *head):
        self.name = name
        self.argtypes = tuple(argtypes)
        self.head = tuple(
            ctypes.c_void_p(v.data_ptr()) if torch.is_tensor(v)
            else ctypes.c_void_p(0) if v is None
            else kind(v)
            for kind, v in zip(self.argtypes, head))
        self._fn = None

    def __call__(self, *tail):
        fn = self._fn
        if fn is None:
            fn = self._fn = function(self.name, self.argtypes)
        rc = fn(*self.head, *tail)
        if rc:
            check(rc, self.name)


_entries: dict = {}


def entry(name: str, argtypes) -> Entry:
    """The shared :class:`Entry` of ``name`` with no fixed arguments (for
    wrappers whose every argument changes from call to call)."""
    found = _entries.get(name)
    if found is None:
        found = _entries[name] = Entry(name, argtypes)
    return found


def _raw_stream_getter():
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


_raw_stream = None


def stream(device_index: int) -> int:
    """PyTorch's current CUDA stream on the device, as an int handle (the
    raw getter TorchInductor launches with: no Stream object per call)."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = _raw_stream_getter()
    return _raw_stream(device_index)


def device_index(device) -> int:
    """The CUDA device index of ``device`` (the current one when None)."""
    device = torch.device(device)
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, got {dtype}")


def plane_suffix(dtype, plane_dtype) -> str:
    """The C entry suffix of a kernel computing in ``dtype`` on planes
    stored as ``plane_dtype``: ``f32``, ``f64`` or ``f32_bf16``."""
    if plane_dtype == dtype:
        return suffix(dtype)
    if plane_dtype == torch.bfloat16 and dtype == torch.float32:
        return "f32_bf16"
    raise TypeError(f"kernels take {dtype} planes, or bfloat16 planes for "
                    f"float32, got {plane_dtype}")


def check_planes(*planes, dtype, device):
    """Every plane tensor on ``device``, contiguous, all stored in one
    dtype that :func:`plane_suffix` takes with ``dtype``; returns it."""
    planes = [t for t in planes if t is not None]
    kinds = {t.dtype for t in planes}
    if len(kinds) > 1:
        raise TypeError("planes stored in several dtypes: "
                        f"{sorted(map(str, kinds))}")
    plane_dtype = kinds.pop() if kinds else dtype
    plane_suffix(dtype, plane_dtype)
    for t in planes:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
    return plane_dtype


def scalar(dtype):
    """The ctypes type of a kernel scalar of the tensors' dtype."""
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def check_cuda(*tensors, dtype, device) -> None:
    """Every tensor: on ``device``, of ``dtype`` (int32 for offsets passed
    as such by the caller), contiguous."""
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype not in (dtype, torch.int32):
            raise TypeError(f"tensor of {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
