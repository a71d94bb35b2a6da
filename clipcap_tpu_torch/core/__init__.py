"""Configuration of the port (its own copies; see config.py) and the dtype
policy (dtypes.py)."""

from .config import CaptionerConfig, GPT2Config, MapperConfig, ViTConfig
from .dtypes import DTypePolicy, default_policy

__all__ = ["CaptionerConfig", "DTypePolicy", "GPT2Config", "MapperConfig", "ViTConfig",
           "default_policy"]
