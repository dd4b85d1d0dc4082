"""Metric readers: `metrics/<reader>.py` gives `read(spec, data) -> float
or None`, `spec` being the metric's file `specs/<metric>.json`. A reader
that finds nothing to read returns None, and the metric is left out."""
