"""Token data sources (``repro.dataio``)."""
