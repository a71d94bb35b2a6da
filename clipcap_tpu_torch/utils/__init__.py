"""Host utilities: metric logging (logging.py), host spans
(profiling.py), and the TPE sweep optimizer (tpe.py)."""
