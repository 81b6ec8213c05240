"""What nvcc made of the tracking kernels: registers, stack, spills, SASS.

Builds the kernel library (``ops/_build.py``), reads each entry
function's registers, stack frame and spill bytes from the ``-Xptxas -v``
build log, disassembles the library with ``cuobjdump -sass`` and, for each
kernel whose mangled name contains one of the given substrings, counts its
instructions by opcode, overall and inside each loop (a range closed by a
backward branch; ``depth`` counts the loops around it): the per-sample
loop is one of those; ``period_loop`` is the instruction count of the
outermost loop that holds a barrier (a CTA's ``BAR`` or a cluster's
``UCGABAR``), the per-period loop of a kernel that consumes once a period.
By default it reports K1 and K4 (the cluster kernel
``cluster_track_kernel`` with ``BlockedLoop`` and ``SimpleLoop``), K2
(``track_full_kernel``), K3 (``correlator_kernel``) and every P1 kernel
(``csrc/probe.cu``: ``probe_variant<V, R>``, ``probe_staging<R>``,
``probe_outstore<R>``, ``probe_narrow``). Writes the full SASS to
``--out`` and prints one JSON line per kernel. Needs ``nvcc`` and
``cuobjdump``, no card.

    python -m gnss_sdr_tpu_torch.tools.sass_report [--out DIR] [name ...]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
from pathlib import Path

from gnss_sdr_tpu_torch.ops import _build

DEFAULT_NAMES = ("BlockedLoop", "track_full_kernel", "SimpleLoop",
                 "correlator_kernel", "probe_")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("cuobjdump not found")


def split_functions(sass: str) -> dict[str, list[str]]:
    """SASS text by function name (``Function : <mangled>`` headers)."""
    funcs: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return funcs


def analyse(lines: list[str]) -> dict:
    """Opcode counts of one function, overall and per loop."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        lm = _LABEL.match(line)
        if lm:
            pending.append(lm.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        instrs.append((addr, m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in instrs:
        if not op.startswith("BRA"):
            continue
        t = _TARGET.search(rest)
        if not t:
            continue
        tgt = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if tgt is not None and tgt <= addr:
            loops.append((tgt, addr))
    loops = sorted(set(loops))
    total = collections.Counter(op for _, op, _ in instrs)
    out_loops = []
    for lo, hi in loops:
        ops = collections.Counter(op for a, op, _ in instrs if lo <= a <= hi)
        depth = sum(o != (lo, hi) and o[0] <= lo and hi <= o[1]
                    for o in loops)
        out_loops.append(dict(start=hex(lo), end=hex(hi), depth=depth,
                              instructions=sum(ops.values()),
                              opcodes=dict(ops.most_common())))
    return dict(instructions=sum(total.values()),
                opcodes=dict(total.most_common()), loops=out_loops)


def period_loop(loops: list[dict]) -> int | None:
    """Instructions in the outermost loop that holds a barrier, or None."""
    for lp in loops:
        if lp["depth"] == 0 and any(op.startswith("BAR") or "CGABAR" in op
                                    for op in lp["opcodes"]):
            return lp["instructions"]
    return None


def report(names=DEFAULT_NAMES, out: Path | None = None) -> list[dict]:
    so = _build.build()
    log = (so.parent / "build.log").read_text()
    res = _build.kernel_resources(log)
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / "libgnss_kernels.sass").write_text(sass)
        (out / "build.log").write_text(log)
    rows = []
    for fname, lines in split_functions(sass).items():
        if not any(n in fname for n in names):
            continue
        a = analyse(lines)
        rows.append(dict(kernel=fname, **res.get(fname, {}), **a,
                         period_loop=period_loop(a["loops"])))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("names", nargs="*", default=list(DEFAULT_NAMES))
    a = ap.parse_args(argv)
    rows = report(a.names, a.out)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0 if rows else 1


if __name__ == "__main__":
    raise SystemExit(main())
