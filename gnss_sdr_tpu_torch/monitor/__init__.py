# Copied from gnss_sdr_tpu/monitor/__init__.py; only the package imports are rewritten.
"""Monitoring: GnssSynchro record, serdes, UDP sinks (reference core/monitor)."""

from gnss_sdr_tpu_torch.monitor.sinks import (
    GnssSynchroMonitor,
    MonitorEphemerisUdpSink,
    MonitorPvtUdpSink,
    decode_monitor_pvt,
    encode_monitor_pvt,
)
from gnss_sdr_tpu_torch.monitor.status import (
    ChannelStatusDisplay,
    render_channel_status,
)
from gnss_sdr_tpu_torch.monitor.synchro import (
    GnssSynchro,
    decode_synchro,
    encode_synchro,
    synchro_to_json,
)

__all__ = [
    "ChannelStatusDisplay",
    "GnssSynchro",
    "render_channel_status",
    "GnssSynchroMonitor",
    "MonitorEphemerisUdpSink",
    "MonitorPvtUdpSink",
    "decode_monitor_pvt",
    "decode_synchro",
    "encode_monitor_pvt",
    "encode_synchro",
    "synchro_to_json",
]
