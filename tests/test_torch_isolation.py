"""The port stands alone: no file of gnss_sdr_tpu_torch/ nor chip_smoke.py
imports JAX or the JAX package, importing the receiver loads no JAX, and
the entry points refuse to run without CUDA unless asked for the CPU."""

import ast
import importlib
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


def _port_imports(path: Path) -> list[tuple[str, str | None, int]]:
    """(module, imported name or None, line) for every ``import
    gnss_sdr_tpu_torch.X`` and ``from gnss_sdr_tpu_torch.X import n`` in
    the file, function bodies included."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(a.name, None, node.lineno) for a in node.names
                      if a.name.split(".")[0] == "gnss_sdr_tpu_torch"]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module.split(".")[0] == "gnss_sdr_tpu_torch"):
            found += [(node.module, a.name, node.lineno) for a in node.names]
    return found


def test_port_imports_resolve():
    """Every port module named in the port's source (and chip_smoke.py)
    imports, and every name taken from one is an attribute or a submodule
    of it: a module copied without the modules it imports lazily fails
    here, not in a user's run."""
    bad = []
    for path in _port_files():
        for mod, name, line in _port_imports(path):
            where = f"{path.relative_to(ROOT)}:{line}"
            try:
                m = importlib.import_module(mod)
            except ImportError as e:
                bad.append(f"{where}: import {mod}: {e}")
                continue
            if name is None or name == "*" or hasattr(m, name):
                continue
            try:
                importlib.import_module(f"{mod}.{name}")
            except ImportError:
                bad.append(f"{where}: {mod} has no {name}")
    assert not bad, "\n".join(bad)


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
    import numpy as np

    from gnss_sdr_tpu_torch import acquisition as acq
    from gnss_sdr_tpu_torch import resolve_device
    from gnss_sdr_tpu_torch.acquisition.roc import measure_roc
    from gnss_sdr_tpu_torch.conditioner import (
        Beamformer,
        ConditionerConfig,
        SignalConditioner,
    )
    from gnss_sdr_tpu_torch.io.device_stream import DeviceStream
    from gnss_sdr_tpu_torch.parallel import device_mesh, make_channel_mesh
    from gnss_sdr_tpu_torch.receiver.plans import gps_l1ca_plan
    from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
    from gnss_sdr_tpu_torch.tracking import Tracker
    from gnss_sdr_tpu_torch.tracking.gaussian import (
        GaussianCarrierTracker,
        GaussianLoopCloser,
    )

    plan = gps_l1ca_plan(2.6e6)
    conf, table, prns = plan.acq_conf, plan.code_table, [1, 2]
    for make in (lambda: Receiver(ReceiverConfig()),
                 lambda: Receiver(ReceiverConfig(num_devices=2)),
                 lambda: make_channel_mesh(),
                 lambda: make_channel_mesh(["cuda:0"]),
                 lambda: device_mesh(1),
                 lambda: Tracker(plan.trk_conf, plan.code_table),
                 lambda: DeviceStream(1024),
                 lambda: resolve_device("cuda"),
                 lambda: acq.FineDopplerAcquisition(conf, table, prns),
                 lambda: acq.TongAcquisition(conf, table, prns),
                 lambda: acq.QuickSyncAcquisition(conf, table, prns),
                 lambda: acq.CccwsrAcquisition(conf, table, prns),
                 lambda: acq.NoncoherentIQAcquisition(conf, table, table,
                                                      prns),
                 lambda: measure_roc(conf, table),
                 lambda: GaussianCarrierTracker(2),
                 lambda: GaussianLoopCloser(2, 1e-3),
                 lambda: SignalConditioner(ConditionerConfig()),
                 lambda: Beamformer(np.ones(4, np.complex64))):
        with pytest.raises(RuntimeError):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_tools_raise_without_cuda():
    """The kernel-bench tools, the scaling tool, the distributed worker
    and the multi-device dry run default to the card and raise without
    one; ``device="cpu"`` runs their plain versions or the CPU path.
    nav_listener and skyplot use no device (tests/test_torch_host_modules.py
    runs them)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip
    from gnss_sdr_tpu_torch.tools import (
        dist_worker,
        kbench,
        mosaic_probe,
        nav_listener,
        scaling,
        skyplot,
    )

    for make in (lambda: kbench.run("simple"),
                 lambda: kbench.run("full", C=1, K=2, iters=1),
                 lambda: mosaic_probe.timed("baseline", "baseline"),
                 lambda: mosaic_probe.run_all(k=1, iters=1, reps=1),
                 lambda: scaling.run((1,), channels=2, steps=1, iters=1),
                 lambda: scaling.main(["--shards", "1"]),
                 lambda: dist_worker.main(["0", "1", "0", "1"]),
                 lambda: dryrun_multichip(1)):
        with pytest.raises(RuntimeError):
            make()
    assert callable(nav_listener.main) and callable(skyplot.main)
    times = scaling.run((1, 2), channels=2, steps=2, iters=1, device="cpu")
    assert sorted(times) == [1, 2] and min(times.values()) > 0
    assert kbench.run("simple", C=1, K=2, iters=1, device="cpu")["kind"] == (
        "simple")
    assert mosaic_probe.timed("narrow", "narrow", reps=1, k=1, iters=1,
                              device="cpu") > 0
