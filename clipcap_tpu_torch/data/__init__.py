"""Image preprocessing (PIL on the host, normalize_on_device on the device)."""
