"""Layout rules for the test suite itself.

The tier-1 run uses ``pytest -n 6 --dist loadfile``: every test of a file
runs on one worker, so a file's module-scoped fixtures are built one after
the other there. ``tests/test_dual_band.py`` holds two such fixtures,
the L1 + L5 and the E5a receiver runs, which take 1146-1536 s on one
worker and alone set the suite's wall near its time limit. One module
fixture per file lets xdist hand the expensive set-ups to different
workers. That file predates the port and is kept as it is until its
split along the two fixtures lands (ROADMAP.md, "Test budget"); it is
the one file allowed two, and the allowance must go with the split.
"""

import ast
from pathlib import Path

TESTS = Path(__file__).resolve().parent
WAITING_FOR_SPLIT = {"test_dual_band.py": ["dual_band_rx", "e5a_rx"]}


def _is_module_fixture(dec: ast.expr) -> bool:
    if not isinstance(dec, ast.Call):
        return False
    f = dec.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    return name == "fixture" and any(
        kw.arg == "scope" and isinstance(kw.value, ast.Constant)
        and kw.value.value == "module"
        for kw in dec.keywords)


def module_fixtures(path: Path) -> list[str]:
    """Names of the functions in ``path`` decorated with a
    ``fixture(scope="module")`` call."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return [node.name for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)
            and any(_is_module_fixture(d) for d in node.decorator_list)]


def test_one_module_fixture_per_file():
    crowded = {p.name: names for p in sorted(TESTS.glob("test_*.py"))
               if len(names := module_fixtures(p)) > 1}
    assert crowded == WAITING_FOR_SPLIT, (
        "more than one scope='module' fixture in a file; under --dist "
        f"loadfile they run back to back on one worker: {crowded}")
