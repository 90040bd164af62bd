"""What the benchmark may import: nothing of JAX or of the JAX package
(top-level names compared whole, so ``repro_torch`` is not ``repro``);
and the reference nothing of the program either."""
import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def _top_names(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not _top_names(path) & NEVER


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_names(path)
    assert not names & (NEVER | {"repro_torch", "perfbench"})
    tree = ast.parse(path.read_text())
    rel = [n for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom) and n.level > 1]
    assert not rel, "the reference reaches outside its package"


def test_whole_names_compared():
    assert "repro_torch".split(".")[0] not in NEVER
