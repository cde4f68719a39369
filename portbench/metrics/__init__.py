"""Metric readers: ``<name>.py`` reads the metric of that name from a
run's :class:`portbench.harness.Record` (``read(rec)``), returning None
where the run holds nothing to read."""
