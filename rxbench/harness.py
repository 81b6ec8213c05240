"""One run of one cell: find the cell's configuration, traffic, limits and
metric readers by name, make the file pool on the device, warm up,
replay for the window, judge what came out.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the names in
``BENCHMARK.json``: ``configs[].file``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np

from rxbench import reference
from rxbench.drive import Spans, replay, sample_periods

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gnss_sdr_tpu")


class Cell:
    """A workload of ``BENCHMARK.json`` with everything found by its
    names."""

    def __init__(self, workload: str, root: Path = ROOT) -> None:
        self.root = root
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads(
            (HERE / "limits" / f"{workload}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.run_seconds = bench["run_seconds"]

    @property
    def file_s(self) -> float:
        """Seconds of signal a capture file of the configuration holds."""
        return float(self.config["file_s"])

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read(run) -> float | None``."""
        path = HERE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "rxbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    as whole names (the port's name begins with the JAX package's)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def rate(signal_s: float, wall_s: float) -> float:
    """Signal seconds processed per wall second of the whole window."""
    return signal_s / wall_s


def seed_words(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of the run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        2, np.uint32).astype(np.uint64).view(np.uint64)[0] >> np.uint64(1))


def make_geometries(cfg: dict, duration_s: float) -> dict:
    """The configuration's geometries over one recording of
    ``duration_s`` seconds (the pool's files end to end)."""
    from rxbench.scenario import Geometry

    return {name: Geometry(duration_s=duration_s, **g)
            for name, g in cfg["geometries"].items()}


def make_pool(cfg: dict, geos: dict, n_files: int, file_s: float,
              seed: int, device, parts: dict | None = None) -> list:
    """``n_files`` consecutive files of ``file_s`` seconds of every band,
    made on ``device`` 1 s at a time, written as 8-bit I/Q (``ibyte``:
    the configuration's counts per unit, rounded, clipped) and held on
    the host as the complex64 that ``Receiver.feed`` takes."""
    import torch

    from rxbench.scenario import Band

    scale = float(cfg["ibyte_counts_per_unit"])
    copy_s = 0.0
    files = [[None] * len(cfg["bands"]) for _ in range(n_files)]
    for bi, b in enumerate(cfg["bands"]):
        band = Band(geos[b["geometry"]], b["signal"], b["fs"], b["cn0_dbhz"],
                    device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed_words(seed, bi))
        step = int(round(b["fs"]))
        per_file = int(round(b["fs"] * file_s))
        for fi in range(n_files):
            host = np.empty(per_file, np.complex64)
            dst = torch.from_numpy(host)
            for off in range(0, per_file, step):
                n = min(step, per_file - off)
                x = band.generate(fi * per_file + off, n, gen)
                q = torch.complex(
                    torch.clamp(torch.round(x.real * scale), -128, 127),
                    torch.clamp(torch.round(x.imag * scale), -128, 127))
                q = q.to(torch.complex64)
                if parts is not None and device.type == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                dst[off:off + n].copy_(q)
                copy_s += time.perf_counter() - t
            files[fi][bi] = host
    if parts is not None:
        parts["pool_copy_s"] = copy_s
    return files


def judge_files(cfg, geos, answers, file_s, limits) -> tuple[dict, int]:
    """The reference's numbers over the files (the worst; counts summed)
    and the number of files with a number over its limit."""
    worst = {k: 0.0 for k in reference.NUMBERS}
    failed = 0
    for ans in answers:
        got = reference.judge(cfg, geos, [ans], file_s)
        if any(not got[k] <= limits[k] for k in reference.NUMBERS):
            failed += 1
        for k in reference.NUMBERS:
            worst[k] = (worst[k] + got[k] if k in reference.COUNTS
                        else max(worst[k], got[k]))
    return worst, failed


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", keep: dict | None = None,
        cell: Cell | None = None, max_files: int | None = None) -> dict:
    """One run; returns the result line's object. With ``keep`` the
    answers, geometries and cell are left in it for a control; ``cell``
    and ``max_files`` let a test run a cut-down cell on the CPU."""
    import torch

    cell = cell or Cell(workload)
    cfg, traffic = cell.config, cell.traffic
    chips = int(cell.workload["chips"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise SystemExit(f"rxbench: {workload} needs {chips} CUDA card(s); "
                         f"torch sees {torch.cuda.device_count()}")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if device == "cuda" else None
    parts = {}
    t = time.perf_counter()
    geos = make_geometries(cfg, traffic["pool_files"] * cell.file_s)
    parts["scenario_s"] = time.perf_counter() - t
    t = time.perf_counter()
    files = make_pool(cfg, geos, traffic["pool_files"], cell.file_s, seed,
                      dev, parts)
    parts["pool_s"] = time.perf_counter() - t
    from gnss_sdr_tpu_torch.ops import _build

    t = time.perf_counter()
    warm = [[x[:int(round(b["fs"] * traffic["warm_s"]))]
             for b, x in zip(cfg["bands"], files[0])]]
    replay(cfg, traffic, warm, math.inf, device=device, sync=sync,
           max_files=1)
    parts["warm_s"] = time.perf_counter() - t
    parts["nvcc_build_s"] = _build.build_seconds or 0.0
    if device == "cuda":
        torch.cuda.synchronize()
    # set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()

    spans = Spans(keep=True) if trace else None
    prof = None
    marks = []
    if trace:
        from rxbench import devtrace

        # the card's activity only: the profiler's host-side recording of
        # every PyTorch op would slow the host, which sets the factor;
        # the host spans are the harness's own clock readings
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        marks.append(devtrace.mark())
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    answers, signal_s, wall_s = replay(cfg, traffic, files, seconds, spans,
                                       device, sync, max_files)
    if trace:
        marks.append(devtrace.mark())
        prof.__exit__(None, None, None)
    loaded = forbidden_modules(__import__("sys").modules)
    if loaded:
        raise SystemExit("rxbench: forbidden modules loaded: "
                         + ", ".join(loaded))
    result: dict = {"correct": False, "attempted": len(answers),
                    "failed": 0, "metrics": {}}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    result["device"] = {
        "platform": "gpu" if device == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name() if device == "cuda"
                 else "cpu"),
        "count": chips, "memory_peak_bytes": int(peak)}
    del files
    factor = rate(signal_s, wall_s)
    values = {"realtime_factor": factor, "setup_s": setup_s}
    sample_periods(answers, seed)
    if trace:
        tr = devtrace.analyse(devtrace.read_trace(prof), spans.intervals,
                              marks)
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        ctx = {"spans": dict(spans.total), "signal_s": signal_s,
               "wall_s": wall_s, "trace": tr,
               "k1_blocks": [devtrace.k1_counts(b) for a in answers
                             for b in a.blocks]}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
        result["spans_ms_per_s"] = {
            k: 1e3 * v / signal_s for k, v in spans.total.items()}
        result["spans_ms_per_s"]["window"] = 1e3 * wall_s / signal_s
        result["idle_by_span_s"] = tr["idle_by_span"]
        result["k1"] = {"launches_traced": tr["k1_launches"],
                        "blocks_counted": len(ctx["k1_blocks"]),
                        "device_s": tr["k1_s"]}
        result["trace_clock_scale"] = tr["clock_scale"]
        result["realtime_factor_traced"] = factor
    else:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    result["setup_parts_s"] = parts
    result["signal_s"] = signal_s
    result["wall_s"] = wall_s
    numbers, failed = judge_files(cfg, geos, answers, cell.file_s,
                                  cell.limits)
    result["failed"] = failed
    result["files"] = [reference.detail(cfg, geos, a, cell.file_s)
                       for a in answers]
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in reference.NUMBERS}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values()) and failed == 0
    if keep is not None:
        keep.update(answers=answers, geos=geos, cell=cell)
    result["checks"] = checks
    return result
