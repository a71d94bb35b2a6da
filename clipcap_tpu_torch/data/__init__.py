"""Image preprocessing (PIL on the host, normalize_on_device on the device),
the COCO-json and folder datasets (coco.py), and the preprocessed-shard
reader and dataset of training (npy_reader.py, token_prefix.py)."""
