# Copied from gnss_sdr_tpu/outputs/gpstime.py; only the package imports are rewritten.
"""GPS time <-> calendar conversion helpers for the output writers.

Reference analog: rtklib_rtkcmn.cc gpst2time/time2epoch. GPS epoch is
1980-01-06 00:00:00 UTC; week rollovers are assumed already resolved into a
full week number by the caller (the telemetry decoder adds the 1024/2048
week offsets the same way the reference does).
"""

from __future__ import annotations

import datetime as _dt

GPS_EPOCH = _dt.datetime(1980, 1, 6, tzinfo=_dt.timezone.utc)


# GPS-UTC offset (leap seconds) as of 2017-01-01; used as the fallback when
# no broadcast UTC parameters (delta_t_LS, IS-GPS-200 §20.3.3.5.1.6) have
# been decoded yet
DEFAULT_LEAP_SECONDS = 18


def gps_to_datetime(week: int, tow_s: float) -> _dt.datetime:
    return GPS_EPOCH + _dt.timedelta(weeks=week, seconds=tow_s)


def gps_to_utc_datetime(
    week: int, tow_s: float, leap_seconds: float = DEFAULT_LEAP_SECONDS
) -> _dt.datetime:
    """GPS time -> UTC: subtract the broadcast delta-t_LS (the reference's
    nmea_printer applies the decoded leap-second offset the same way)."""
    return GPS_EPOCH + _dt.timedelta(weeks=week, seconds=tow_s - leap_seconds)


def datetime_to_gps(t: _dt.datetime) -> tuple[int, float]:
    dt = t - GPS_EPOCH
    week = dt.days // 7
    tow = (dt.days - week * 7) * 86400 + dt.seconds + dt.microseconds * 1e-6
    return week, tow
