"""No module of the benchmark imports JAX or the JAX package, and the
reference side imports nothing of the program. Top-level module names
are compared whole: the program's name begins with the JAX package's."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tpurt"}
#: The yardstick's reference side: what decides ``correct`` and the
#: roofline may not lean on the program.
REFERENCE_SIDE = ("reference.py", "scene.py", "check.py", "roofline.py")


def _sources():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_program(name):
    path = os.path.join(BENCH, "yardstick", name)
    tops = imported_tops(path)
    assert "tpurt_torch" not in tops and not tops & FORBIDDEN
    with open(path) as f:
        text = f.read()
    assert "import oracle" not in text and "from oracle" not in text


def test_the_run_compares_whole_top_level_names(monkeypatch):
    import sys
    sys.path[:0] = [BENCH]
    from yardstick import runner

    fake = dict(sys.modules)
    for k in [k for k in fake if k.split(".")[0] in FORBIDDEN]:
        del fake[k]
    fake["tpurt_torch.render"] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert runner.forbidden_modules() == []
    fake["tpurt.render.megakernel"] = object()
    fake["jax"] = object()
    assert runner.forbidden_modules() == ["jax", "tpurt"]
