"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: ``repro_torch`` is not ``repro``), and the plain
references import nothing of the measured package."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(imported(f) & FORBIDDEN)
           for f in files if imported(f) & FORBIDDEN}
    assert not bad


def test_the_references_import_nothing_of_the_measured_package():
    bad = {str(f.relative_to(BENCH)): sorted(imported(f))
           for f in sorted((BENCH / "reference").rglob("*.py"))
           if {"repro_torch", "repro"} & imported(f)}
    assert not bad


def test_the_check_compares_top_level_names_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import bridge\n")
    assert not imported(f) & FORBIDDEN
    f.write_text("import repro.core\n")
    assert imported(f) & FORBIDDEN == {"repro"}
    f.write_text("from jax import numpy\n")
    assert imported(f) & FORBIDDEN == {"jax"}
