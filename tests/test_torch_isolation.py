"""The port stands alone: no file of gnss_sdr_tpu_torch/ nor chip_smoke.py
imports JAX or the JAX package, importing the receiver loads no JAX, and
the entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "gnss_sdr_tpu"}


def _port_files():
    return sorted((ROOT / "gnss_sdr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_receiver_import_loads_no_jax():
    code = ("import sys, gnss_sdr_tpu_torch.receiver.receiver; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gnss_sdr_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gnss_sdr_tpu_torch import resolve_device
    from gnss_sdr_tpu_torch.io.device_stream import DeviceStream
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking import Tracker

    plan = gps_l1ca_plan(2.6e6)
    for make in (lambda: Receiver(ReceiverConfig()),
                 lambda: Tracker(plan.trk_conf, plan.code_table),
                 lambda: DeviceStream(1024),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_tools_raise_without_cuda():
    """The kernel-bench tools default to the card and raise without one;
    ``device="cpu"`` runs their plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gnss_sdr_tpu_torch.tools import kbench, mosaic_probe

    for make in (lambda: kbench.run("simple"),
                 lambda: kbench.run("full", C=1, K=2, iters=1),
                 lambda: mosaic_probe.timed("baseline", "baseline"),
                 lambda: mosaic_probe.run_all(k=1, iters=1, reps=1)):
        with pytest.raises(RuntimeError):
            make()
    assert kbench.run("simple", C=1, K=2, iters=1, device="cpu")["kind"] == (
        "simple")
    assert mosaic_probe.timed("narrow", "narrow", reps=1, k=1, iters=1,
                              device="cpu") > 0
