"""Trace generation (numpy copy of ``repro.data``)."""
