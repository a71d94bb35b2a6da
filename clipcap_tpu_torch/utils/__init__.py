"""Host utilities: metric logging (logging.py), tracing and step timing
(profiling.py), and the TPE sweep optimizer (tpe.py)."""
