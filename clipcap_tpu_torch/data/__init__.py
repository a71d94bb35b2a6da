"""Image preprocessing (PIL on the host, normalize_on_device on the device),
the COCO-json and folder datasets (coco.py), webdataset tar shards
(webdataset.py), the native JPEG decoder and shard loader (native_jpeg.py,
native_loader.py: ctypes bindings of native/*.cpp, built at first use),
the preprocessed-shard reader and dataset of training (npy_reader.py,
token_prefix.py) and the host-to-device prefetch (pipeline.py)."""

from .npy_reader import NumpyShardReader, write_npy_shard
from .token_prefix import MultiplePrefixDataset, TokenPrefixDataset

__all__ = ["MultiplePrefixDataset", "NumpyShardReader", "TokenPrefixDataset",
           "write_npy_shard"]
