"""No module of the benchmark imports JAX or the JAX package, or reads the
JAX benchmark's folder; the reference imports nothing of the port."""

import ast
import re

from portbench.harness import FORBIDDEN, HERE, forbidden_modules

SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 20


def test_no_jax_and_no_jax_package():
    for path in SOURCES:
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_names_are_compared_whole():
    assert forbidden_modules(["kuberay_tpu_torch.serve", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["kuberay_tpu.models", "jax._src",
                              "flax"]) == ["flax", "jax._src",
                                           "kuberay_tpu.models"]


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "kuberay_tpu_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_benchmark_folder():
    pat = re.compile(r"""["'/]benchmark(/|["'])""")
    for path in SOURCES:
        assert not pat.search(path.read_text()), path
