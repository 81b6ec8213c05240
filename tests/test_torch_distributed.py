"""The port's two-process ``torch.distributed`` channel sharding, through
``parallel.dryrun.dryrun_multichip`` on two CPU shards.

The dry run first tracks 4 channels over two shards in this process
(bit-equal to the unsharded engine) and runs a sharded PCPS. Then two
real processes (``gnss_sdr_tpu_torch.tools.dist_worker``, gloo on the
CPU, 4 shards a rank) split one signal group's 8 channels and gather the
per-period Doppler rows to rank 0, as tests/test_distributed.py's JAX
processes do. The gathered rows must equal the port's single-process
unsharded eager run bit for bit, and the JAX ``track_block`` rows of
tests/test_distributed.py's recipe within tests/test_torch_dll_pll.py's
Doppler tolerance (0.1 Hz). A worker that exits non-zero fails the run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnss_sdr_tpu.codes.gps_l1_ca import gps_l1_ca_code_table
from gnss_sdr_tpu.tracking.conf import DllPllConf
from gnss_sdr_tpu.tracking.dll_pll import init_state
from gnss_sdr_tpu.tracking.dll_pll import track_block as jtrack_block
from gnss_sdr_tpu.utils.cplx import dev_combine, host_to_ri
from gnss_sdr_tpu_torch.parallel.distributed import (
    dryrun_conf,
    dryrun_inputs,
    run_blocks,
)
from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip, run_workers
from gnss_sdr_tpu_torch.tracking.dll_pll import track_block

torch.set_num_threads(2)

C = 8


def _jax_rows():
    """tests/test_distributed.py's single-process JAX reference."""
    conf = DllPllConf(
        fs=1.023e6 * 1.25, code_length_chips=1023, code_rate_cps=1.023e6,
        carrier_freq_hz=1575.42e6, max_channels=C, steps_per_block=4)
    state = jax.jit(lambda: init_state(conf)._replace(
        enabled=jnp.ones((C,), bool),
        carrier_doppler=jnp.linspace(-2000.0, 2000.0, C).astype(
            jnp.float32)))()
    rng = np.random.default_rng(0)
    win = jnp.asarray(host_to_ri(
        (rng.normal(size=conf.window_samples)
         + 1j * rng.normal(size=conf.window_samples)).astype(np.complex64)))
    codes = jnp.asarray(gps_l1_ca_code_table()[np.arange(C) % 32])
    pos0 = state.pos
    new_state, outs = jtrack_block(conf, state, dev_combine(win), codes)
    for _ in range(2):
        new_state, outs = jtrack_block(
            conf, new_state._replace(pos=pos0), dev_combine(win), codes)
    return np.asarray(outs.carrier_doppler.astype(jnp.float32))


def test_two_process_channel_sharding():
    run = dryrun_multichip(2, device="cpu", timeout=60)

    conf = dryrun_conf(4)                       # the in-process shards
    state, window, codes = dryrun_inputs(conf, "cpu")
    ref = run_blocks(lambda s, w, c: track_block(conf, s, w, c),
                     state, window, codes, 3).numpy()
    assert not run["fused"]
    np.testing.assert_array_equal(run["rows"], ref)
    assert run["acq_statistic"].shape == (4,)

    rows = run["dist"]["rows"]
    assert rows.shape == (4, C)                  # [steps, channels]
    assert run["dist"]["launches"] == [0, 0]     # no kernel on the CPU
    conf = dryrun_conf(C)
    state, window, codes = dryrun_inputs(conf, "cpu")
    ref = run_blocks(lambda s, w, c: track_block(conf, s, w, c),
                     state, window, codes, 3).numpy()
    np.testing.assert_array_equal(rows, ref)

    jrows = _jax_rows()
    assert np.abs(rows - jrows).max() < 0.1, np.abs(rows - jrows).max()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_failed_worker_fails_the_run():
    """Without a card a ``--device cuda`` worker exits non-zero, and the
    run raises with its output."""
    with pytest.raises(RuntimeError, match="exited 1(.|\n)*CUDA is not "
                                           "available"):
        run_workers(2, 1, device="cuda", timeout=60)
