"""Image preprocessing (PIL on the host, normalize_on_device on the device)
and the COCO-json and folder datasets (coco.py)."""
