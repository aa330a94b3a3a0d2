"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name
(before the first dot) is compared whole, since the port's name begins
with the JAX package's."""
import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "nope_nerf_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def python_files(top):
    for base, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_jax_anywhere_under_the_benchmark():
    found = {p: top_level_imports(p) & FORBIDDEN
             for p in python_files(BENCH)}
    assert not {p: n for p, n in found.items() if n}


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    found = {p: top_level_imports(p) & (FORBIDDEN | {"nope_nerf_tpu_torch"})
             for p in python_files(ref)}
    assert not {p: n for p, n in found.items() if n}


def test_names_are_compared_whole():
    assert "nope_nerf_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN
