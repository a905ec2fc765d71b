"""Nothing the harness or its reference runs imports JAX or the JAX
package (top-level names compared whole), and the reference imports
nothing of the port.  Each check runs in a fresh interpreter."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from lp_bench.lib import spec

BENCH = spec.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "pysparselp_tpu"}


def _loaded_after(code):
    prog = (f"import sys; sys.path.insert(0, {str(spec.ROOT)!r})\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    # one thread, as the test workers have: the tests run side by side
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT, env=env)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = """
from lp_bench.lib import harness, spec
from lp_bench.tests.helpers import run_cpu, tiny_cell
for m in spec.load_spec()["per_layer"]:
    spec.metric_reader(m["name"])
for w in spec.load_spec()["workloads"]:
    assert run_cpu(tiny_cell(w["name"], size=8), seconds=1.0)["correct"]
assert not harness.forbidden_modules()
"""
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN
    assert "pysparselp_tpu_torch" in loaded      # the port is not caught


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import lp_bench.reference.potts")
    assert not loaded & (FORBIDDEN | {"pysparselp_tpu_torch"})


def test_no_source_imports_them():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, path
            if "reference" in path.parts:
                assert "pysparselp_tpu_torch" not in tops, path


def test_forbidden_modules_compares_whole_names():
    from lp_bench.lib import harness

    sys.modules.setdefault("pysparselp_tpu_torch_fake", type(sys)("x"))
    try:
        assert "pysparselp_tpu" not in harness.forbidden_modules()
        sys.modules["pysparselp_tpu"] = type(sys)("pysparselp_tpu")
        assert harness.forbidden_modules() == ["pysparselp_tpu"]
    finally:
        sys.modules.pop("pysparselp_tpu", None)
        sys.modules.pop("pysparselp_tpu_torch_fake", None)


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "potts300.steady", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=600, cwd=Path(spec.ROOT))
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and "correct" not in out.stdout
