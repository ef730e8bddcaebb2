"""Access-frequency statistics (numpy copy of ``repro.core.freq``)."""
