"""Nothing of kbench imports JAX or the JAX package, and the reference
imports nothing of the port: top-level module names compared whole
(kmdiff_tpu_torch begins with kmdiff_tpu)."""

import ast
import os
import sys

from kbench import run

BANNED = {"jax", "jaxlib", "flax", "kmdiff_tpu"}


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def _py_files(top: str):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_in_kbench():
    for path in _py_files(run.KBENCH):
        assert not _imports(path) & BANNED, path
    assert set(run.BANNED) >= BANNED


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(run.KBENCH, "reference")
    # what the reference imports of kbench, and what those import in turn
    todo = list(_py_files(ref))
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
                for m in mods:
                    assert m.split(".")[0] not in BANNED | {"kmdiff_tpu_torch"}, (path, m)
                    if m.startswith("kbench"):
                        base = os.path.join(run.ROOT, *m.split("."))
                        todo += [p for p in (base + ".py", os.path.join(base, "__init__.py"))
                                 if os.path.exists(p)]
    assert any(p.endswith("cohort.py") for p in seen)


def test_the_banned_check_compares_whole_names(monkeypatch):
    import types

    for name in ("kmdiff_tpu_torch_fake.cli", "jaxtyping_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.fake", types.ModuleType("jax.fake"))
    assert run.banned_modules() == ["jax"]
