"""Architecture configs of the port (``get_config``/``smoke_config``)."""

from .arch import ArchConfig, BlockCfg
from .registry import ARCHS, get_config, list_archs, smoke_config

__all__ = ["ArchConfig", "BlockCfg", "ARCHS", "get_config", "list_archs", "smoke_config"]
