"""Spreading codes (GPS L1 C/A; Galileo E1 in ``codes.galileo_e1``)."""

from gnss_sdr_tpu_torch.codes.gps_l1_ca import gps_l1_ca_code, gps_l1_ca_code_sampled
from gnss_sdr_tpu_torch.codes.resample import resample_code
