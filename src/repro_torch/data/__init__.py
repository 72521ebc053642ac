"""Training data sources (torch port of ``repro.data``)."""
