"""Signal constants (GPS L1 C/A; Galileo E1 in
``constants.galileo_e1``)."""

from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S, GPS_WEEK_SECONDS
from gnss_sdr_tpu_torch.constants import gps_l1_ca
