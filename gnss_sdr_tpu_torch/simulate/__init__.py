"""Scenario simulators (synthetic captures with known truth): GPS L1 C/A
here, Galileo E1 in ``simulate.galileo``."""

from gnss_sdr_tpu_torch.simulate.scenario import GpsScenario, ScenarioConfig
