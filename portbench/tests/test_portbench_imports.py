"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either; names are compared by
their whole top-level part (the program's name begins with the JAX
package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "micronet_tpu"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def files(sub=""):
    return sorted((HERE / sub).rglob("*.py"))


@pytest.mark.parametrize("path", files(), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not set(imported(path)) & JAX


@pytest.mark.parametrize("path", files("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(imported(path)) & (JAX | {"micronet_tpu_torch", "chip_smoke", "tools"})


def test_the_scan_tells_the_names_apart(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import micronet_tpu_torch\nfrom micronet_tpu.nn import x\nimport jaxfoo\n")
    assert set(imported(f)) == {"micronet_tpu_torch", "micronet_tpu", "jaxfoo"}
    assert set(imported(f)) & JAX == {"micronet_tpu"}
