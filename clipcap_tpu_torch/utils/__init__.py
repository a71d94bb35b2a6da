"""Host utilities: metric logging (logging.py), and tracing and step timing (profiling.py)."""
