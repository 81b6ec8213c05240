"""Monitoring: the channel-status console table (``monitor/status.py``),
the GnssSynchro record and its serialisation (``monitor/synchro.py``) and
the tracking and acquisition dumps (``monitor/dumps.py``), copies of the
JAX package's. The UDP sinks are not ported yet."""
