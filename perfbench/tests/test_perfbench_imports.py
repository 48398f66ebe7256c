"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package ``repro``, compared by whole top-level module name
(``repro_torch``, the port, is not ``repro``)."""
from __future__ import annotations

import ast

from perfbench import bench, registry


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_in_the_harness():
    found = {}
    for path in registry.HERE.rglob("*.py"):
        if {"tests", "out"} & set(path.relative_to(registry.HERE).parts):
            continue
        for name in _imports(path):
            if name.split(".")[0] in bench.FORBIDDEN:
                found[str(path)] = name
    assert not found


def test_top_level_names_compare_whole():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.serve",
                                    "perfbench.run", "jaxtyping"]) == []
    assert bench.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                    "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]
