"""Report tables and timing helpers for the port's scripts
(``utils/reporting.py``, ``utils/profiling.py``)."""
