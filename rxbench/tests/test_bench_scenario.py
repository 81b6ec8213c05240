"""The device generator's copy equals the port's NumPy generator on the
same samples (no noise), on the CPU."""

import numpy as np
import pytest
import torch

from rxbench import scenario

GEOM = dict(tow_start_s=7314.0, duration_s=70.0, rx_lat_deg=41.275,
            rx_lon_deg=1.9876, rx_height_m=80.0, max_sats=8,
            min_elevation_deg=15.0)


@pytest.mark.parametrize("start_s", [0.0, 61.3])
def test_gps_l1_matches_the_port(start_s):
    from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig

    geo = scenario.Geometry("G", 1, rx_clock_bias_s=2.1e-4, **GEOM)
    band = scenario.Band(geo, "L1CA", 2.6e6, 46.0, torch.device("cpu"))
    ref = GpsScenario(ScenarioConfig(
        fs=2.6e6, tow_start_s=7314.0, duration_s=70.0, cn0_dbhz=46.0,
        rx_clock_bias_s=2.1e-4, max_sats=8, min_elevation_deg=15.0, seed=1,
        noise=False))
    assert geo.prns == ref.prns
    start, n = int(start_s * 2.6e6), 260_000
    got = band.generate(start, n, None).numpy().astype(np.complex64)
    np.testing.assert_array_equal(got, ref.generate(start, n))


@pytest.mark.parametrize("start_s", [0.0, 41.7])
def test_e5a_matches_the_port(start_s):
    from gnss_sdr_tpu_torch.simulate.galileo import (
        GalileoScenario,
        GalileoScenarioConfig,
    )
    from gnss_sdr_tpu_torch.simulate.multiband import GalileoE5aBand

    geo = scenario.Geometry("E", 4, rx_clock_bias_s=1.3e-4,
                            **dict(GEOM, duration_s=50.0))
    band = scenario.Band(geo, "E5a", 10.4e6, 47.0, torch.device("cpu"))
    prim = GalileoScenario(GalileoScenarioConfig(
        fs=2.6e6, tow_start_s=7314.0, duration_s=50.0, cn0_dbhz=46.0,
        rx_clock_bias_s=1.3e-4, max_sats=8, seed=4, noise=False))
    ref = GalileoE5aBand(prim, fs=10.4e6, cn0_dbhz=47.0, noise=False)
    assert geo.prns == prim.prns
    start, n = int(start_s * 10.4e6), 1_040_000
    got = band.generate(start, n, None).numpy().astype(np.complex64)
    np.testing.assert_array_equal(got, ref.generate(start, n))


def test_noise_follows_the_seed():
    geo = scenario.Geometry("G", 1, rx_clock_bias_s=2.1e-4, **GEOM)
    band = scenario.Band(geo, "L1CA", 2.6e6, 46.0, torch.device("cpu"))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return band.generate(0, 1000, g)

    assert torch.equal(draw(2**31 + 5), draw(2**31 + 5))
    assert not torch.equal(draw(2**31 + 5), draw(2**31 + 6))
