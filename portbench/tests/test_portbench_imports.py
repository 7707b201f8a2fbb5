"""No file of the benchmark imports JAX, flax, optax or the JAX package
(top-level names compared whole: ``dc_vic_tpu_torch`` is not
``dc_vic_tpu``), and the plain reference imports nothing of the program."""
import ast
import os

import pytest

from portbench import harness

FILES = sorted(os.path.join(p, f) for p, _, fs in os.walk(harness.PKG) for f in fs
               if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "dc_vic_tpu_torch" not in top_level_imports(path)


def test_names_compare_whole():
    assert harness.forbidden_modules() == [] or "dc_vic_tpu" not in harness.forbidden_modules()
    import dc_vic_tpu_torch  # noqa: F401  (begins with the JAX package's name)
    assert "dc_vic_tpu" not in harness.forbidden_modules()
