"""The benchmark's own CPU tests: ``python -m pytest rxbench/tests -n 8``
from the repository root. They need no card and no JAX. Each process
computes on one thread, as the benchmark's runs do, so that several
workers share the cores without contention."""

import os

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
