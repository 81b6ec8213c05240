"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names; the generator and the reference import nothing of
the port."""

import ast
from pathlib import Path

from rxbench import harness

HERE = Path(harness.__file__).resolve().parent


def test_whole_top_level_names():
    mods = ["gnss_sdr_tpu_torch", "gnss_sdr_tpu_torch.receiver.receiver",
            "numpy", "jaxtyping", "gnss_sdr_tpu_torchx"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "gnss_sdr_tpu", "gnss_sdr_tpu.ops"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_yardstick_imports_nothing_of_the_port():
    yardstick = [HERE / "reference.py", HERE / "truth.py",
                 HERE / "scenario.py", HERE / "devtrace.py",
                 *(HERE / "frozen").rglob("*.py"),
                 *(HERE / "metrics").glob("*.py")]
    for path in yardstick:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "gnss_sdr_tpu_torch" not in tops, path
