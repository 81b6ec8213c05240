"""K1, K2 and K4 against their plain versions on a noise window, period by
period.

    PYTHONPATH=. python tests/fused_noise_divergence.py [--save DIR] [SEED ...]

The inputs are those of ``test_torch_cuda.py``'s K1, K2 and K4 cases
(``torch_cases.fused_noise_case`` and ``simple_noise_case``: random codes,
a Gaussian noise window, positions 5 + 37 c, Dopplers from -2500 to
2500 Hz; for K1 and K2 2-period integration with FLL, the atan2 flag on
one channel; disabled channels inside and past the end of the window) at
C = 1, 8, 33, 60 and 140, with the soft and the hard code replica (K4 at
T = 3 and 5), over two launches of K = 20, for each seed (default 11, the
tests' seed). For each kernel, case and seed it prints one JSON line: the
worst relative difference on the checked lanes over the first 1, 2, 5, 10,
20 and 40 periods, the lane, channel and period of the largest difference,
the channels whose rows part by more than 2e-3, and whether lanes 10 and
17 are equal. With ``--save DIR`` the rows of every comparison with a
channel above 2e-3 go to ``DIR/<kernel>_C<C>_<replica>_T<T>_s<seed>.npz``
(``ref``, ``got``, ``scal``). ``gnss_sdr_tpu_torch`` comes from the path,
so ``PYTHONPATH`` set to another checkout puts that checkout's kernels
through the same inputs. Needs a CUDA device; imports no JAX.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from torch_cases import (
    CHECK_LANES,
    EXACT_LANES,
    TAPS,
    TAPS5,
    fused_noise_case,
    run_simple,
    run_tracker,
    simple_noise_case,
)

CHANNELS = (1, 8, 33, 60, 140)
HORIZONS = (1, 2, 5, 10, 20, 40)


def divergence(ref, got, lanes=CHECK_LANES) -> dict:
    """Worst relative difference over the checked lanes for each horizon,
    where the largest one sits, and the channels above 2e-3."""
    worst = {}
    for upto in HORIZONS:
        w = 0.0
        for ln in lanes:
            a, b = ref[:, :upto, ln], got[:, :upto, ln]
            w = max(w, float(np.abs(a - b).max())
                    / max(1e-6, float(np.abs(a).max())))
        worst[upto] = w
    best, at, over = -1.0, None, set()
    for ln in lanes:
        a, b = ref[:, :, ln], got[:, :, ln]
        rel = np.abs(a - b) / max(1e-6, float(np.abs(a).max()))
        over.update(int(c) for c in np.nonzero((rel > 2e-3).any(1))[0])
        if rel.max() > best:
            best = float(rel.max())
            c, k = np.unravel_index(int(rel.argmax()), rel.shape)
            at = dict(lane=ln, channel=int(c), period=int(k))
    exact = all(np.array_equal(ref[:, :, ln], got[:, :, ln])
                for ln in EXACT_LANES)
    return dict(worst=worst, at=at, channels_over_2e3=sorted(over),
                lanes_10_17_exact=exact)


def report(kernel, vs, case, ref, got, scal, save, lanes=CHECK_LANES):
    d = divergence(ref, got, lanes)
    print(json.dumps(dict(kernel=kernel, vs=vs, **case, **d)), flush=True)
    if save is not None and d["channels_over_2e3"]:
        name = (f"{kernel}_vs_{vs}_C{case['C']}_{case['replica']}"
                f"_T{case['T']}_s{case['seed']}.npz")
        np.savez(save / name, ref=ref, got=got, scal=scal)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fused_noise_divergence: no CUDA device", file=sys.stderr)
        return 1
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1

    save = None
    if argv[:1] == ["--save"]:
        save = Path(argv[1])
        save.mkdir(parents=True, exist_ok=True)
        argv = argv[2:]
    dev = torch.device("cuda")
    for seed in [int(a) for a in argv] or [11]:
        for C in CHANNELS:
            for interp in (True, False):
                spec, window, codes, scal, disabled = fused_noise_case(
                    C, interp, k1.make_blocked_spec, seed)
                spec2 = fused_noise_case(C, interp, k2.make_full_spec,
                                         seed)[0]
                case = dict(C=C, replica="soft" if interp else "hard", T=3,
                            seed=seed, disabled=disabled)
                plain = run_tracker(k1.track_blocked_plain, spec, window,
                                    codes, scal, 2, dev)
                rows = {}
                for name, fn, sp in (("K1", k1.track_blocked, spec),
                                     ("K2", k2.track_full, spec2)):
                    rows[name] = run_tracker(fn, sp, window, codes, scal, 2,
                                             dev)
                    report(name, "plain", case, plain, rows[name], scal, save)
                report("K2", "K1", case, rows["K1"], rows["K2"], scal, save)
                for taps in (TAPS, TAPS5):
                    spec4, window4, codes4, scal4, disabled4 = (
                        simple_noise_case(C, interp, taps,
                                          k2.make_simple_spec, seed=seed))
                    T = len(taps)
                    case4 = dict(case, T=T, disabled=disabled4)
                    plain4 = run_simple(k2.track_simple_plain, spec4,
                                        window4, codes4, scal4, 2, dev)
                    got4 = run_simple(k2.track_simple, spec4, window4,
                                      codes4, scal4, 2, dev)
                    report("K4", "plain", case4, plain4, got4, scal4, save,
                           lanes=list(range(2 * T)) + list(range(10, 20)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
