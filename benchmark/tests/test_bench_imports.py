"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: ``baryonforge_torch`` begins with ``baryonforge_t`` but is not
``baryonforge_tpu``."""

import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "baryonforge_tpu"}
RUN = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    """Top-level names of every absolute import in a file (relative ones
    stay inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "baryonforge_torch" not in names
    assert names <= {"math", "numpy", "torch", "warnings", "operator",
                     "itertools", "dataclasses"}


def test_the_check_compares_whole_names():
    from benchmark import harness
    import sys
    sys.modules.setdefault("jaxy_stub_for_test", sys)
    try:
        assert "jaxy_stub_for_test" not in harness.forbidden()
    finally:
        del sys.modules["jaxy_stub_for_test"]
    assert "baryonforge_torch" not in harness.FORBIDDEN


def test_the_shared_shell_code_keeps_the_program_inside_functions():
    # benchmark.shells and the config modules import the program only
    # inside the functions of its side, so the reference side loads alone
    for path in [BENCH / "shells.py"] + sorted(
            (BENCH / "configs").glob("*.py")):
        tree = ast.parse(path.read_text())
        top = {n.module.split(".")[0] if isinstance(n, ast.ImportFrom)
               and n.module else None for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))}
        assert "baryonforge_torch" not in top
