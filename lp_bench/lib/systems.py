"""What the drivers call: the system under test, or the control in its
place.

:class:`PortSystem` is ``pysparselp_tpu_torch`` through its public entries:
the LP built by the modeling API (``ImageLP``), ``SparseLP.solve`` with
``method="chambolle_pock_ppd"``, and ``examples.potts.
solve_batch_segmentation``.  :class:`ControlSystem` is the plain reference
run in the program's place in a lower precision (the check's control): it
answers the same calls with the same shapes of output.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import potts as ref

DTYPES = {"float32": np.float32, "float64": np.float64}


class PortSystem:
    """The system under test on ``device``, in the configuration's dtype."""

    def __init__(self, device: str, dtype: str):
        self.device = device
        self.dtype = DTYPES[dtype]

    def build(self, config: dict, unary: np.ndarray):
        """The configuration's LP for one integer unary image, built through
        the port's modeling API."""
        from pysparselp_tpu_torch.examples.potts import ImageLP

        mul = float(config["coef_mul"])
        lp = ImageLP()
        idx = lp.add_variables_array(shape=unary.shape + (1,), lower_bounds=0,
                                     upper_bounds=1,
                                     costs=unary[:, :, None] / mul)
        lp.add_pott_model(idx[:, :, 0], round(config["coef_potts"] * mul) / mul)
        return lp

    def solve(self, lp, **kw):
        """One ``SparseLP.solve``; returns ``(x, curves)``: the solution and
        the checkpoint curves (iterations, host seconds, primal energy,
        dual bound, worst inequality residual)."""
        x, _ = lp.solve(method="chambolle_pock_ppd", device=self.device,
                        dtype=self.dtype, light_metrics=True, **kw)
        return np.asarray(x), {
            "itrn": np.asarray(lp.itrn_curve),
            "opttime": np.asarray(lp.opttime_curve),
            "energy1": np.asarray(lp.pobj_curve),
            "energy2": np.asarray(lp.dobj_curve),
            "viol": np.asarray(lp.max_violated_inequality)}

    def segment_batch(self, images, coef_potts, nb_iter, nb_iter_plot):
        """One batched segmentation call; returns ``(maps, curves)``: the
        ``(B, H, W)`` relaxed label maps and the ``(P, B)`` curves."""
        from pysparselp_tpu_torch.examples.potts import solve_batch_segmentation

        maps, info = solve_batch_segmentation(
            images, coef_potts, nb_iter=nb_iter, nb_iter_plot=nb_iter_plot,
            device=self.device, dtype=self.dtype)
        return np.asarray(maps), {
            "itrn": np.asarray(info["itrn"]),
            "opttime": np.asarray(info["opttime"]),
            "energy1": np.asarray(info["energy1"]),
            "energy2": np.asarray(info["energy2"]),
            "viol": np.asarray(info["max_violated_inequality"]),
            "backend": info["backend"]}


class ControlSystem:
    """The plain reference's Chambolle-Pock in ``dtype`` (bfloat16: the
    precision below the configurations' float32) in the program's place.
    ``iterations`` fixes the iterations of a call that the program runs
    until a time limit, so the control does the program's work."""

    def __init__(self, device: str, config: dict, dtype=torch.bfloat16,
                 iterations=None):
        self.device = device
        self.config = config
        self.dtype = dtype
        self.iterations = iterations

    def build(self, config: dict, unary: np.ndarray):
        lp = ref.PottsLP(unary.shape[0], unary.shape[1], config["coef_potts"],
                         config["coef_mul"])
        return lp, np.asarray(unary)

    def _curves(self, curves, t0):
        p = len(curves["itrn"])
        out = dict(curves)
        out["opttime"] = np.linspace(0.0, time.perf_counter() - t0, p + 1)[1:]
        return out

    def solve(self, lp, nb_iter, nb_iter_plot, max_time=None, stop_tol=None,
              **_):
        plp, unary = lp
        t0 = time.perf_counter()
        iters = self.iterations if max_time is not None and self.iterations \
            else nb_iter
        x, curves = ref.cp_run(plp, unary[None], iters, dtype=self.dtype,
                               device=self.device, chunk=nb_iter_plot,
                               stop_tol=stop_tol)
        c = self._curves(curves, t0)
        return x[0], {k: (v[:, 0] if k in ("energy1", "energy2", "viol")
                          else v) for k, v in c.items()}

    def segment_batch(self, images, coef_potts, nb_iter, nb_iter_plot):
        mul = float(self.config["coef_mul"])
        unary = np.round(np.asarray(images) * mul)
        bsz, h, w = unary.shape
        plp = ref.PottsLP(h, w, self.config["coef_potts"], mul)
        t0 = time.perf_counter()
        x, curves = ref.cp_run(plp, unary, self.iterations or nb_iter,
                               dtype=self.dtype, device=self.device,
                               chunk=nb_iter_plot)
        return x[:, :plp.n_pix].reshape(bsz, h, w), self._curves(curves, t0)
