"""K1 and K2 against their plain version on a noise window, period by period.

    PYTHONPATH=. python tests/fused_noise_divergence.py [SEED ...]

The inputs are those of ``test_torch_cuda.py``'s K1 and K2 cases
(``torch_cases.fused_noise_case``: random codes, a Gaussian noise window,
positions 5 + 37 c, Dopplers from -2500 to 2500 Hz, 2-period integration
with FLL, the atan2 flag on one channel, disabled channels inside and
past the end of the window) at C = 1, 8, 33, 60 and 140, with the soft
and the hard code replica, over two launches of K = 20, for each seed
(default 11, the tests' seed). For each kernel, case and seed it prints one JSON line: the
worst relative difference on the checked lanes over the first 1, 2, 5, 10,
20 and 40 periods, the lane, channel and period of the largest difference,
the channels whose rows part by more than 2e-3, and whether lanes 10 and
17 are equal. ``gnss_sdr_tpu_torch`` comes from the path, so
``PYTHONPATH`` set to another checkout puts that checkout's kernels
through the same inputs. Needs a CUDA device; imports no JAX.
"""

import json
import sys

import numpy as np
import torch

from torch_cases import CHECK_LANES, EXACT_LANES, fused_noise_case, run_tracker

CHANNELS = (1, 8, 33, 60, 140)
HORIZONS = (1, 2, 5, 10, 20, 40)


def divergence(ref, got) -> dict:
    """Worst relative difference over the checked lanes for each horizon,
    where the largest one sits, and the channels above 2e-3."""
    worst = {}
    for upto in HORIZONS:
        w = 0.0
        for ln in CHECK_LANES:
            a, b = ref[:, :upto, ln], got[:, :upto, ln]
            w = max(w, float(np.abs(a - b).max())
                    / max(1e-6, float(np.abs(a).max())))
        worst[upto] = w
    best, at, over = -1.0, None, set()
    for ln in CHECK_LANES:
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("fused_noise_divergence: no CUDA device", file=sys.stderr)
        return 1
    from gnss_sdr_tpu_torch.ops import track_kernel as k2
    from gnss_sdr_tpu_torch.ops import track_kernel_blocked as k1

    dev = torch.device("cuda")
    for seed in [int(a) for a in argv] or [11]:
        for C in CHANNELS:
            for interp in (True, False):
                spec, window, codes, scal, disabled = fused_noise_case(
                    C, interp, k1.make_blocked_spec, seed)
                spec2 = fused_noise_case(C, interp, k2.make_full_spec,
                                         seed)[0]
                case = dict(C=C, replica="soft" if interp else "hard",
                            seed=seed, disabled=disabled)
                plain = run_tracker(k1.track_blocked_plain, spec, window,
                                    codes, scal, 2, dev)
                rows = {}
                for name, fn, sp in (("K1", k1.track_blocked, spec),
                                     ("K2", k2.track_full, spec2)):
                    rows[name] = run_tracker(fn, sp, window, codes, scal, 2,
                                             dev)
                    print(json.dumps(dict(kernel=name, vs="plain", **case,
                                          **divergence(plain, rows[name]))),
                          flush=True)
                print(json.dumps(dict(kernel="K2", vs="K1", **case,
                                      **divergence(rows["K1"], rows["K2"]))),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
