"""Nothing of the benchmark imports JAX or the JAX package (compared by
whole top-level names: ``ray_tpu_torch`` is the program, ``ray_tpu`` is
not), and the reference and the yardstick import nothing of the program."""

import ast
import sys

import pytest

from perfbench import run
from perfbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ray_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources():
    return sorted(spec.BENCH_DIR.rglob("*.py"))


def test_no_jax_or_jax_package_anywhere():
    for path in _sources():
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)


@pytest.mark.parametrize("part", ["reference", "core"])
def test_yardstick_does_not_import_the_program(part):
    for path in (spec.BENCH_DIR / part).rglob("*.py"):
        assert "ray_tpu_torch" not in set(_imports(path)), path


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.fake_mod", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ray_tpu.fake_mod", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "ray_tpu.fake_mod"]


def test_a_cpu_process_exits_without_a_result(capsys):
    assert run.main(["--workload", "deepseek7b.train.s4k", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""
