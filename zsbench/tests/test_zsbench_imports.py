"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program. Top-level module names are compared whole:
``zeroshape_tpu_torch`` begins with ``zeroshape_tpu``."""

import ast
import subprocess
import sys

from zsbench import manifest
from zsbench.run import FORBIDDEN

PORT = "zeroshape_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in manifest.HERE.rglob("*.py"):
        assert not top_level_imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.HERE / "reference").rglob("*.py"):
        assert PORT not in top_level_imports(path), path


def loaded_after(statement):
    code = f"{statement}\nimport sys\nprint(sorted({{m.split('.')[0] for m in sys.modules}}))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=manifest.ROOT).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_loaded_modules_when_imported():
    mods = loaded_after("import zsbench.run, zsbench.calibrate, zsbench.program, zsbench.runners.recon, "
                        "zsbench.runners.train, zsbench.runners.score")
    assert PORT in mods and not mods & set(FORBIDDEN)
    ref = loaded_after("import zsbench.reference.graph, zsbench.reference.init, zsbench.reference.recon, "
                       "zsbench.reference.precision, zsbench.reference.search, zsbench.reference.surface, "
                       "zsbench.scenes, zsbench.work, zsbench.tracing")
    assert PORT not in ref and not ref & set(FORBIDDEN)
