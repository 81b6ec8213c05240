"""Monitoring: the channel-status console table (``monitor/status.py``, a
copy of the JAX package's). The GnssSynchro record, its serialisation and
the UDP sinks are not ported yet."""
