"""The import guard: neither JAX nor the JAX package may be loaded.

Module names are compared by their top-level part, the name before the
first dot, whole: ``syncopy_tpu_torch`` passes, ``syncopy_tpu`` does not."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "syncopy_tpu"})


def forbidden(modules=None):
    """Sorted top-level names of `modules` (default ``sys.modules``) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def imports_of(path):
    """Top-level names that the Python source at `path` imports (absolute
    imports only; relative ones stay inside their package)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".", 1)[0])
    return found
