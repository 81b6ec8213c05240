"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python -m rxbench.run --workload dual16.replay --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout. ``--trace 1`` runs the window under the
profiler and reports the per-layer metrics instead of the end-to-end
ones. The numbers compared for ``correct`` follow the result on standard
error and, under ``checks``, as the result's last key.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux: its
    start tick in /proc against the boot time clock)."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths, so that only a checkout's first run builds (the port's nvcc
# library already lives in gnss_sdr_tpu_torch/_build/)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / ".rxbench_cache" / _sub)
# one receiver process with one BLAS/OpenMP thread: the host's other cores
# stay idle, so the window's load is the same from run to run
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from rxbench import harness

    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    print(json.dumps({"setup_parts_s": res["setup_parts_s"]}), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
