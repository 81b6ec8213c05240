"""Scenario simulators (synthetic captures with known truth): GPS L1 C/A
here, Galileo E1 in ``simulate.galileo``; and the multi-satellite baseband
generator of the SignalGenerator source (``simulate.generator``)."""

from gnss_sdr_tpu_torch.simulate.generator import (
    SatelliteSignalParams,
    generate_baseband,
)
from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig

__all__ = ["GpsScenario", "SatelliteSignalParams", "ScenarioConfig",
           "generate_baseband"]
