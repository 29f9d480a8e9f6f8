"""Nothing under ``portbench/`` imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program), and
nothing reads the JAX package's benchmark folder ``benchmarks/``."""
import ast

import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402

FILES = sorted(K.BENCH.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH = "bench" + "marks"       # the JAX package's folder, spelt apart


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(K.ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(K.ROOT)))
def test_nothing_reads_the_jax_benchmarks(path):
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert JAX_BENCH + "/" not in node.value and \
                node.value != JAX_BENCH, f"{path}: {node.value!r}"


def test_the_program_is_repro_torch_only():
    names = {m.split(".")[0] for p in FILES for m in _imports(p)}
    assert "repro_torch" in names and "repro" not in names
