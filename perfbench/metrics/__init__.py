"""Metric readers: ``<name>.py`` reads the metric of that name from a
finished ``harness.Run``, or returns None where the run has nothing to
read (the harness then leaves the metric out of the line)."""
