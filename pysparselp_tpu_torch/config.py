# Verbatim copy of pysparselp_tpu/config.py (tests/test_torch_slice.py holds the two equal); in the port `mesh` takes a pysparselp_tpu_torch.parallel.mesh.Mesh.
"""Typed per-solver configuration (SURVEY §5 "config system").

The reference configures everything through loose keyword arguments on
``solve()`` (``pysparselp/SparseLP.py:990-1002``) plus hardcoded flags inside
each solver (``ADMM.py:66-71``).  Here every solver owns a **frozen
dataclass** collecting exactly the keywords it accepts; dispatch validates
incoming kwargs against it (typo'd options raise immediately, listing the
valid fields — instead of a ``TypeError`` deep inside the solver or a
silently ignored flag) and solvers are invoked from the typed instance.

Usage — both spellings are equivalent, kwargs stay supported for parity::

    lp.solve(method="admm2", nb_iter=2000, adaptive_rho=True)
    lp.solve(config=Admm2Config(nb_iter=2000, adaptive_rho=True))

Explicit keyword arguments override ``config`` fields.
"""

from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Options shared by every solver (the reference's common ``solve``
    parameters, ``SparseLP.py:990-1002``)."""

    method: typing.ClassVar[str] = ""

    nb_iter: int = 10000
    nb_iter_plot: int = 10
    max_time: float | None = None
    dtype: typing.Any = None

    def solver_kwargs(self) -> dict:
        """Per-solver kwargs (everything beyond the common four)."""
        common = {f.name for f in dataclasses.fields(SolverConfig)}
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in common
        }

    @classmethod
    def field_names(cls) -> frozenset:
        return frozenset(f.name for f in dataclasses.fields(cls))


@dataclasses.dataclass(frozen=True)
class ChambollePockConfig(SolverConfig):
    """Flagship first-order solver (``ChambollePockPPD.py:36``) + the
    TPU-side acceleration/layout options."""

    method: typing.ClassVar[str] = "chambolle_pock_ppd"

    alpha: float = 1.0
    theta: float = 1.0
    restart: str | None = None          # "average" = PDLP restart-to-average
    omega: float | str | None = None    # primal weight; "auto" to estimate
    restart_period: int | None = None
    stop_tol: float | None = None
    permute: typing.Any = "auto"        # False | "rcm" | "align" | "auto"
    mesh: typing.Any = None             # jax.sharding.Mesh -> row-sharded
    x30: typing.Any = None              # full-state resume
    y_eq0: typing.Any = None
    y_ineq0: typing.Any = None
    save_problem: bool = False
    light_metrics: bool = False         # checkpoint cost: 1 device fetch


@dataclasses.dataclass(frozen=True)
class AdmmConfig(SolverConfig):
    """Penalized-equality ADMM (``ADMM.py:47``)."""

    method: typing.ClassVar[str] = "admm"

    gamma_eq: float = 2.0
    gamma_ineq: float = 3.0
    nb_inner: int = 2
    omega: float = 1.0
    use_preconditioning: bool = True
    inner: str = "jacobi"               # "jacobi" | "gauss_seidel" (native)
    stop_tol: float | None = None
    mesh: typing.Any = None
    light_metrics: bool = False         # checkpoint cost: 1 device fetch


@dataclasses.dataclass(frozen=True)
class Admm2Config(SolverConfig):
    """Exact-KKT ADMM (``ADMM.py:272``)."""

    method: typing.ClassVar[str] = "admm2"

    gamma_ineq: float = 0.7
    alpha: float = 1.95
    dense_threshold: int = 4096
    use_preconditioning: bool = False
    adaptive_rho: bool = False
    stop_tol: float | None = None
    mesh: typing.Any = None
    light_metrics: bool = False         # checkpoint cost: 1 device fetch


@dataclasses.dataclass(frozen=True)
class AdmmBlocksConfig(SolverConfig):
    """Consensus block-decomposition ADMM (``ADMMBlocks.py:45``)."""

    method: typing.ClassVar[str] = "admm_blocks"

    gamma_ineq: float = 0.7
    alpha: float = 1.95
    use_preconditioning: bool = True
    use_lu: bool = True
    stop_tol: float | None = None
    mesh: typing.Any = None
    light_metrics: bool = False         # checkpoint cost: 1 device fetch


@dataclasses.dataclass(frozen=True)
class MehrotraConfig(SolverConfig):
    """Mehrotra predictor-corrector PDIP (``MehrotraPDIP.py:110``)."""

    method: typing.ClassVar[str] = "mehrotra"

    eps: float = 1e-9
    theta: float = 0.9995
    verbose: int = 0
    error_check: bool = False
    dense_threshold: int = 4096
    mesh: typing.Any = None             # column-sharded normal equations


@dataclasses.dataclass(frozen=True)
class DualGradientAscentConfig(SolverConfig):
    """Dual gradient ascent with exact line search
    (``DualGradientAscent.py:68``)."""

    method: typing.ClassVar[str] = "dual_gradient_ascent"

    y_eq: typing.Any = None
    y_ineq: typing.Any = None
    seed: int = 0
    stop_tol: float | None = None
    mesh: typing.Any = None             # row-sharded ascent


@dataclasses.dataclass(frozen=True)
class DualCoordinateAscentConfig(SolverConfig):
    """Dual coordinate ascent (``DualCoordinateAscent.py:39``)."""

    method: typing.ClassVar[str] = "dual_coordinate_ascent"

    y_eq: typing.Any = None
    y_ineq: typing.Any = None
    seed: int = 1
    use_greedy_round: bool = True
    mode: str = "sequential"            # "sequential" | "blocked"
    mesh: typing.Any = None             # mesh= implies the blocked mode


@dataclasses.dataclass(frozen=True)
class ScipyConfig(SolverConfig):
    """scipy.optimize.linprog bridge (``SparseLP.py:1101-1132``)."""

    method: typing.ClassVar[str] = "scipy_interior_point"


@dataclasses.dataclass(frozen=True)
class OsqpConfig(SolverConfig):
    """OSQP bridge (``SparseLP.py:1340-1373``)."""

    method: typing.ClassVar[str] = "osqp"


@dataclasses.dataclass(frozen=True)
class CvxpyConfig(SolverConfig):
    """CVXPY bridge to ECOS/SCS/CVXOPT (``SparseLP.py:930-988``)."""

    method: typing.ClassVar[str] = "ECOS"
    solver: str | None = None


CONFIG_CLASSES: dict = {
    "chambolle_pock_ppd": ChambollePockConfig,
    "admm": AdmmConfig,
    "admm2": Admm2Config,
    "admm_blocks": AdmmBlocksConfig,
    "mehrotra": MehrotraConfig,
    "dual_gradient_ascent": DualGradientAscentConfig,
    "dual_coordinate_ascent": DualCoordinateAscentConfig,
    "scipy_simplex": ScipyConfig,
    "scipy_interior_point": ScipyConfig,
    "osqp": OsqpConfig,
    "ECOS": CvxpyConfig,
    "SCS": CvxpyConfig,
    "CVXOPT": CvxpyConfig,
}


def resolve_config(method: str, solver_kwargs: dict) -> SolverConfig | None:
    """Build the typed config for ``method`` from loose kwargs, raising a
    helpful error on unknown options.  Returns None for unregistered
    methods (external bridges keep their own validation)."""
    cls = CONFIG_CLASSES.get(method)
    if cls is None:
        return None
    valid = cls.field_names()
    unknown = set(solver_kwargs) - valid
    if unknown:
        raise TypeError(
            f"unknown option(s) {sorted(unknown)} for method {method!r}; "
            f"valid options: {sorted(valid)}"
        )
    return cls(**solver_kwargs)
