"""Metric readers: ``<metric>.py`` (or ``<family>.py``) with ``read(ctx)``."""
