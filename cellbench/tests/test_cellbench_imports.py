"""Nothing under cellbench/ imports JAX, the JAX package or the JAX
package's benchmarks, and the reference imports nothing of the program;
module names are compared by their whole top-level name (the port's name
begins with the JAX package's)."""
import ast
import subprocess
import sys

import pytest

from cellbench.run import FORBIDDEN, ROOT

BENCH = ROOT / "cellbench"
PORT = "pathtracer_gaussiansplatting_tpu_torch"


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    bad = top_level_imports(path) & (set(FORBIDDEN) | {"benchmarks"})
    assert not bad, f"{path} imports {bad}"


PLAIN = {"__future__", "dataclasses", "functools", "math", "typing", "numpy",
         "scipy", "torch"}


def test_reference_imports_nothing_of_the_program():
    """The reference imports plain libraries and its own modules only."""
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert top_level_imports(path) <= PLAIN, path


def test_whole_name_match():
    """The port's own name is not taken for the JAX package's."""
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "pathtracer_gaussiansplatting_tpu" in FORBIDDEN


def test_a_run_loads_no_jax():
    """A rehearsal of a cell, in a fresh process, holds none of them."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from cellbench.rehearse import rehearse; "
            "from cellbench.run import forbidden_modules; "
            "r = rehearse('fit.cloud1m', seconds=0.2); "
            "print(r['correct'], forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
