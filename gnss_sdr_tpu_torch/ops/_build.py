"""Build the CUDA sources under ``csrc/`` at first use and load them.

Every ``csrc/*.cu`` is compiled with its own nvcc process (all started
together) into an object file, then linked into one shared library with a
plain C interface, loaded with ctypes. The build directory
``gnss_sdr_tpu_torch/_build/`` is keyed by a hash of the sources and the
flags, so an edit rebuilds and an unchanged tree loads the cached
library. Nothing is imported or compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# per-source flags: the probe's multiply-add chains must round like their
# plain versions, so nvcc may not contract a*b+c into an FMA there. The
# trackers (K1, K2, K4) build with contraction on: the sums of their period
# geometry and closures are written with __fadd_rn and friends
# (csrc/track_loop.cuh, csrc/track_simple.cu), which round as written under
# any flag.
FILE_FLAGS = {"probe.cu": ["-fmad=false"]}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
build_log: str = ""


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(repr((ARCH_FLAGS, COMMON_FLAGS, FILE_FLAGS)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds, build_log
    sources = _sources()
    out_dir = BUILD_ROOT / _key(sources)
    so = out_dir / "libgnss_kernels.so"
    if so.exists():
        build_seconds = 0.0 if build_seconds is None else build_seconds
        if not build_log and (out_dir / "build.log").exists():
            build_log = (out_dir / "build.log").read_text()
        return so
    t0 = time.perf_counter()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in sources:
        obj = tmp / (s.stem + ".o")
        cmd = ([nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *FILE_FLAGS.get(s.name, []),
                "-Xptxas", "-v", "-c", str(s), "-o", str(obj)])
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for s, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"--- {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / so.name),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    if out_dir.exists():
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        tmp.rename(out_dir)
    build_log = "\n".join(logs)
    (out_dir / "build.log").write_text(build_log)
    build_seconds = time.perf_counter() - t0
    return so


def kernel_resources(log: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of each entry function, read
    from the ``-Xptxas -v`` lines of a build log; keyed by mangled name."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # K1 takes K2's arguments and its cluster shape
    fused = [
        p, i,            # window (float2 [L]), L
        p, i,            # codes (f32 [C, code_len]), code_len
        p, i,            # scalars (f32 [C, ns]), ns
        p,               # pos (int32 [C])
        p,               # out (f32 [C, K, 128])
        i, i, i,         # C, K, n_max
        p, i,            # params (host f32 [16]), num_taps
        i, i, i,         # pll_order, dll_order, interp_code
        i, i,            # track_pilot, fdma
        p, p, p,         # dcodes (f32 [C, code_len]), sec_p, sec_d
        p,               # sec (host int32 [5]): widths, lengths, lcm
    ]
    lib.gnss_track_full.argtypes = fused + [p]            # stream
    lib.gnss_track_full.restype = i
    lib.gnss_track_blocked.argtypes = fused + [
        i, i,            # CTAs per channel (cluster size), slice width
        p,               # stream
    ]
    lib.gnss_track_blocked.restype = i
    lib.gnss_track_blocked_max_clusters.argtypes = [
        i, i, i, i,      # C, code_len, n_max, interp_code
        i, i, i,         # num_taps, track_pilot, fdma
        i, i,            # cluster size, slice width
        ctypes.POINTER(ctypes.c_int),   # out: clusters resident at once
    ]
    lib.gnss_track_blocked_max_clusters.restype = i
    for entry in ("gnss_track_blocked_smem", "gnss_track_full_smem"):
        fn = getattr(lib, entry)
        fn.argtypes = [
            i, i, i, i,  # code_len, interp_code, num_taps, track_pilot
            i,           # fdma
            i,           # slice width (K1) or n_max (K2)
            ctypes.POINTER(ctypes.c_int),   # out: bytes a CTA needs
            ctypes.POINTER(ctypes.c_int),   # out: the card's limit
        ]
        fn.restype = i
    lib.gnss_correlator.argtypes = [
        p, i,            # x (float2 [C, N]), N
        p, p, i, i,      # codes, dcodes (f32 [C, Q*128]), Q*128, code_len
        p,               # scalars (f32 [C, 8])
        p,               # out (f32 [C, 1, 128])
        i,               # C
        p, i,            # tap offsets (host f32 [5]), T
        i, i,            # interp_code, track_pilot
        i, i,            # CTAs per channel (cluster size), slice width
        p,               # stream
    ]
    lib.gnss_correlator.restype = i
    lib.gnss_track_simple.argtypes = [
        p, i,            # window (float2 [L]), L
        p, i,            # codes (f32 [C, code_len]), code_len
        p,               # scalars (f32 [C, 10])
        p,               # out (f32 [C, K, 128])
        i, i, i,         # C, K, n_max
        p, i,            # params (host f32 [32]), num_taps
        i, i, i,         # pll_order, dll_order, interp_code
        i, i,            # CTAs per channel (cluster size), slice width
        p,               # stream
    ]
    lib.gnss_track_simple.restype = i
    lib.gnss_track_simple_max_clusters.argtypes = [
        i, i, i, i, i,   # C, code_len, n_max, interp_code, num_taps
        i, i,            # cluster size, slice width
        ctypes.POINTER(ctypes.c_int),   # out: clusters resident at once
    ]
    lib.gnss_track_simple_max_clusters.restype = i
    lib.gnss_probe.argtypes = [
        i,               # variant (tools/mosaic_probe.py VARIANTS)
        p,               # x (f32 [4096, 128])
        p, p, p,         # out (f32 [8, 128]), sums (f32 [32, 2]),
                         # big (f32 [32, 200, 128], out store only)
        i,               # K
        i,               # CTAs per channel (cluster size)
        p,               # stream
    ]
    lib.gnss_probe.restype = i
    lib.gnss_error_string.argtypes = [i]
    lib.gnss_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().gnss_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
