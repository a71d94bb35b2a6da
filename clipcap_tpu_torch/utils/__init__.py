"""Host utilities: metric logging."""
