"""The readings that set the limits of ``correct``: the port's numbers
and the control's on the same files, seed after seed, in one process.

    python -m rxbench.control --workload gps8.replay --seconds 30 \
        --seeds 101 102 103

For each seed one whole run of the cell (``harness.run``: its pool, its
warm-up, its window), then the reference computed in float32 and put in
the port's place on that run's files (``reference.control``). One JSON
line per seed: the port's numbers, the control's, and the run's
end-to-end metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from rxbench import harness, reference

    for seed in args.seeds:
        keep: dict = {}
        res = harness.run(args.workload, seed, args.seconds, False,
                          time.perf_counter(), keep=keep)
        cell = keep["cell"]
        ctl = reference.control(cell.config, keep["geos"], keep["answers"],
                                cell.file_s, np.float32)
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "program": {k: v["value"] for k, v in res["checks"].items()},
            "control_float32": ctl,
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "setup_parts_s": res["setup_parts_s"], "files": res["files"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
