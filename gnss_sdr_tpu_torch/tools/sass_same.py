"""Whether two builds' GPS tracker kernels are the same code.

    python -m gnss_sdr_tpu_torch.tools.sass_same A/libgnss_kernels.sass \
        B/libgnss_kernels.sass

Takes two SASS dumps written by ``python -m
gnss_sdr_tpu_torch.tools.sass_report --out DIR`` (one from each
checkout) and, for every instantiation of K1 (``BlockedLoop``), K4
(``SimpleLoop``) and K2 (``track_full_kernel``) at T = 3 or 5, with and
without the pilot mode, without FDMA, in both replica forms, prints one
JSON line: whether the instruction text is the same instruction for
instruction (addresses dropped), the instruction counts, and where the
counts differ, the opcodes whose counts do. Templates named before and
after the pilot mode and FDMA existed (``BlockedLoop<3>``,
``BlockedLoop<3, false>`` and ``BlockedLoop<3, false, false>``) are
matched; the FDMA instantiations (new in the second dump) are not.
"""

from __future__ import annotations

import collections
import json
import re
import sys
from pathlib import Path

from gnss_sdr_tpu_torch.tools.sass_report import split_functions

# (kernel, T, pilot, interp) and (kernel, T, interp, pilot): the pilot
# flag is absent from the oldest names, FDMA (false) from the older ones
_KERNELS = (
    (re.compile(r"(BlockedLoop|SimpleLoop)ILi(\d)E(?:Lb([01])E)?(?:Lb0E)?"
                r"EELb([01])E"), (0, 1, 3, 2)),
    (re.compile(r"(track_full)_kernelILi(\d)ELb([01])E(?:Lb([01])E)?"
                r"(?:Lb0E)?E"), (0, 1, 2, 3)),
)


def instructions(lines):
    out = []
    for line in lines:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m:
            out.append(m.group(1).strip())
    return out


def opcodes(instrs):
    """Opcode counts, a guard predicate (``@!P0``) dropped."""
    return collections.Counter(
        i.split()[1] if i.startswith("@") else i.split()[0] for i in instrs)


def gps_kernels(path):
    found = {}
    for name, lines in split_functions(Path(path).read_text()).items():
        for pat, order in _KERNELS:
            m = pat.search(name)
            if m:
                g = m.groups()
                kind, taps, interp, pilot = (g[i] for i in order)
                found[(kind, taps, interp, pilot or "0")] = instructions(
                    lines)
    return found


def main(a_path, b_path):
    a, b = gps_kernels(a_path), gps_kernels(b_path)
    for key in sorted(a.keys() & b.keys()):
        ia, ib = a[key], b[key]
        ca, cb = opcodes(ia), opcodes(ib)
        print(json.dumps(dict(
            kernel=key[0], taps=int(key[1]), interp=key[2] == "1",
            pilot=key[3] == "1",
            same_text=ia == ib, instructions=[len(ia), len(ib)],
            opcodes_differing={op: [ca[op], cb[op]] for op in ca | cb
                               if ca[op] != cb[op]})))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
