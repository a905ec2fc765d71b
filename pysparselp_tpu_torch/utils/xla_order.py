"""Reductions in the order XLA's CPU backend computes them, so that a
metric the JAX package computes under ``jax.jit`` on the CPU comes out of
the port bit for bit (float32 and float64).

* :func:`xla_sum` is ``jnp.sum`` of a vector.  XLA rewrites a reduction
  of more than 32 entries into windows of 32 (the vector padded with zeros
  to a multiple of 32, ``pad // 2`` of them in front), each window summed
  in turn from 0, and repeats on the window sums until at most 32 are
  left, which it sums in turn from 0.
* :func:`xla_dot` is ``jnp.dot`` of two vectors, a one-row GEMV: the
  first eight products rounded and summed in turn, every later product a
  fused multiply-add into the running sum (two entries: a product, then a
  fused multiply-add).  A sequential chain, so it runs in compiled C++
  (``native/_xla_dot.cpp``, built with ``g++`` on first use into the
  repository's ``build/pysparselp_tpu_torch/``; a failed build raises).

Both read the order from XLA's compiled code on an x86-64 CPU (the
``reduce-window`` of the optimized HLO, the ``col_major_gemv`` of its LLVM
IR). :func:`total` and :func:`dot` use them for CPU tensors and keep
torch's reductions for every other device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

WINDOW = 32

_LIB = None


def xla_sum(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(v)`` of a 1-D float tensor as XLA's CPU backend orders it
    (a 0-d tensor of ``v``'s dtype)."""
    v = v.reshape(-1)
    if v.numel() == 0:
        return v.new_zeros(())
    while True:
        pad = -v.numel() % WINDOW
        w = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        w = w.reshape(-1, WINDOW)
        acc = torch.zeros(w.shape[0], dtype=v.dtype, device=v.device)
        for k in range(WINDOW):
            acc = acc + w[:, k]
        if acc.numel() == 1:
            return acc[0]
        v = acc


def _load():
    """The compiled dot, built with ``g++`` on first use (cached by a hash
    of its source); a failed build raises."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from ..ops._build import BUILD_DIR

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "_xla_dot.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"_xla_dot_{digest}.so")
    if not os.path.isfile(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        done = subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared",
                               "-fPIC", "-std=c++17", "-o", tmp, src],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ could not build {src}:\n{done.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    for name, typ in (("pslp_xla_dot_f32", ctypes.c_float),
                      ("pslp_xla_dot_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.restype = typ
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    _LIB = lib
    return lib


def xla_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b)`` of two 1-D CPU tensors of one float dtype (float32
    or float64) as XLA's CPU backend orders it (a 0-d tensor)."""
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise TypeError(f"xla_dot takes two float32 or float64 vectors, "
                        f"not {a.dtype} and {b.dtype}")
    if a.device.type != "cpu" or b.device.type != "cpu":
        raise ValueError("xla_dot runs on CPU tensors")
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    if a.numel() != b.numel():
        raise ValueError(f"xla_dot: {a.numel()} against {b.numel()} entries")
    lib = _load()
    fn = (lib.pslp_xla_dot_f32 if a.dtype == torch.float32
          else lib.pslp_xla_dot_f64)
    value = fn(a.data_ptr(), b.data_ptr(), a.numel())
    return torch.tensor(value, dtype=a.dtype)


def total(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` in XLA's CPU order for a CPU tensor, else ``torch.sum``."""
    return xla_sum(v) if v.device.type == "cpu" else torch.sum(v)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot`` in XLA's CPU order for CPU tensors, else ``torch.dot``."""
    return xla_dot(a, b) if a.device.type == "cpu" else torch.dot(a, b)
