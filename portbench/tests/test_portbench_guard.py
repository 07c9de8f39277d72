"""The import guard: names compared by their whole top-level part."""

from portbench.core import guard, manifest


def test_forbidden_names():
    assert guard.forbidden(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert guard.forbidden(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]
    assert guard.forbidden(["syncopy_tpu.ops"]) == ["syncopy_tpu"]
    assert guard.forbidden(["syncopy_tpu_torch", "syncopy_tpu_torch.ops", "jaxtyping",
                            "portbench.core"]) == []


def test_harness_sources_import_no_jax():
    for path in sorted(manifest.BENCH_DIR.rglob("*.py")):
        if "tests" in path.parts:
            continue
        assert not guard.imports_of(path) & guard.FORBIDDEN, path


def test_imports_of_reads_absolute_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom syncopy_tpu.ops import x\nfrom . import y\n"
                   "import numpy\n")
    assert guard.imports_of(src) == {"jax", "syncopy_tpu", "numpy"}
